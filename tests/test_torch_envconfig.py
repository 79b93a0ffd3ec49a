"""The port's table of environment knobs: the reference's API over the
port's own variables."""

import re
from pathlib import Path

import pytest

from repro import envconfig as j_envconfig
from repro_torch import envconfig

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
_NAME = re.compile(r"[\"'](SPIN_[A-Z0-9_]+)[\"']")


def _names_read_in_the_port() -> set[str]:
    names = set()
    for path in SRC.rglob("*.py"):
        if path.name != "envconfig.py":
            names |= set(_NAME.findall(path.read_text()))
    return names


def test_registered_names_are_the_ports_variables():
    """Every knob the port's sources name is registered, every registered
    knob is named by the module the table says reads it, and each is the
    JAX package's knob of the same name."""
    names = envconfig.registered_names()
    assert isinstance(names, frozenset) and names == set(envconfig.ENV_VARS)
    assert _names_read_in_the_port() == names
    for name in names:
        row = envconfig.spec(name)
        assert row.name == name and row.kind in ("str", "int", "float", "bool", "path",
                                                 "json")
        owner = SRC.joinpath(*row.owner.split(".")[1:]).with_suffix(".py")
        assert name in owner.read_text(), (name, owner)
        assert j_envconfig.spec(name).kind == row.kind, name
    assert names <= j_envconfig.registered_names()


def test_env_table_markdown_has_one_row_a_knob():
    lines = envconfig.env_table_markdown().splitlines()
    assert lines[:2] == ["| Variable | Type | Default | Purpose |", "|---|---|---|---|"]
    rows = lines[2:]
    assert [r.split("|")[1].strip().strip("`") for r in rows] == \
        [v.name for v in envconfig.ENV_VARS.values()]
    for r, v in zip(rows, envconfig.ENV_VARS.values()):
        assert r.count("|") == 5 and v.kind in r and v.description in r
        assert ("*(unset)*" in r) == (v.default is None)


def test_accessors(monkeypatch):
    monkeypatch.delenv("SPIN_PRECISION_TOL", raising=False)
    assert not envconfig.is_set("SPIN_PRECISION_TOL")
    assert envconfig.env_float("SPIN_PRECISION_TOL", 0.5) == 0.5
    monkeypatch.setenv("SPIN_PRECISION_TOL", "  ")
    assert not envconfig.is_set("SPIN_PRECISION_TOL")
    monkeypatch.setenv("SPIN_PRECISION_TOL", "1e-3")
    assert envconfig.is_set("SPIN_PRECISION_TOL")
    assert envconfig.env_float("SPIN_PRECISION_TOL") == 1e-3
    monkeypatch.setenv("SPIN_PRECISION_TOL", "tight")
    with pytest.raises(ValueError, match="must be a number"):
        envconfig.env_float("SPIN_PRECISION_TOL")
    for fn in (envconfig.env_float, envconfig.is_set, envconfig.spec):
        with pytest.raises(KeyError):
            fn("SPIN_" + "NOT_A_KNOB")
