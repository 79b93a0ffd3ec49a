"""Shared test fixtures + a graceful fallback when `hypothesis` is absent.

Four SPIN-core test modules import `hypothesis` at module scope; without it
they fail COLLECTION, which in `pytest -x` kills the whole run. Environments
with the pinned dev requirements (see requirements-dev.txt) get the real
library; bare environments get a minimal deterministic stand-in registered
in sys.modules before the test modules import, covering exactly the subset
this suite uses:

  * `strategies.sampled_from` / `strategies.integers`
  * `@given(*strategies)` — draws `max_examples` example tuples
  * `@settings(max_examples=…, deadline=…)` — applied above @given

The stand-in is deliberately NOT a property-testing engine (no shrinking,
no database, no coverage-guided generation). Draws are seeded per-test from
the test name, so failures reproduce run-to-run; `sampled_from` cycles its
options before drawing randomly so every listed case is exercised at least
once whenever max_examples ≥ len(options).
"""

from __future__ import annotations

import random
import sys
import types
import zlib

try:
    import hypothesis  # noqa: F401 — the real thing wins when installed
except ImportError:
    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

    def _sampled_from(options):
        options = list(options)
        state = {"i": 0}

        def draw(rnd):
            i = state["i"]
            state["i"] = i + 1
            if i < len(options):        # full coverage first, then random
                return options[i]
            return rnd.choice(options)

        return _Strategy(draw)

    def _integers(min_value=0, max_value=2 ** 31 - 1):
        return _Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def _given(*strategies):
        def deco(fn):
            # NOT functools.wraps: copying fn's signature would make pytest
            # treat the strategy-supplied parameters as fixtures. The
            # wrapper takes no arguments at all, like a plain test.
            def wrapper():
                n = getattr(wrapper, "_max_examples", 10)
                rnd = random.Random(zlib.crc32(fn.__qualname__.encode()))
                for _ in range(n):
                    fn(*[s._draw(rnd) for s in strategies])
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__module__ = fn.__module__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(max_examples=10, deadline=None, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.sampled_from = _sampled_from
    _st.integers = _integers
    _hyp.strategies = _st
    _hyp.__is_repro_stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# ---------------------------------------------------------------------------
# Hermetic plan cache: tests must neither read a developer's persistent
# ~/.cache/repro_spin/plans.json (stale plans would change planner-dependent
# test outcomes) nor write to it. Respect an explicit override.
# ---------------------------------------------------------------------------

import os
import tempfile

if "SPIN_PLAN_CACHE" not in os.environ:
    os.environ["SPIN_PLAN_CACHE"] = os.path.join(
        tempfile.mkdtemp(prefix="spin_plan_cache_"), "plans.json")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
