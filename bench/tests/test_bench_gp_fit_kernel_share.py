"""`gp.fit_kernel_share`: the share of the window's outermost `gp.fit` spans
that ran K4 (`path` "kernel"), on synthetic records: its value, nested fits
left out, and None without fit spans or without a `path` on them (a program
that records none).

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
from repro_torch import trace  # noqa: E402

T0 = 1000.0
READ = harness.load_reader("gp.fit_kernel_share")


def _ns(t: float) -> int:
    return round((T0 + t) * 1e9)


def _program(fits):
    """One step holding the given fits, each `(attrs, nested attrs or None)`."""
    out = [("search.step", _ns(1.0), _ns(9.0), None, {"seed": 7})]
    t = 1.5
    for attrs, nested in fits:
        parent = len(out)
        out.append(("gp.fit", _ns(t), _ns(t + 0.5), 0, dict(attrs)))
        if nested is not None:
            out.append(("gp.fit", _ns(t + 0.1), _ns(t + 0.2), parent,
                        dict(nested)))
        t += 1.0
    return out


def _record():
    return {"window_s": 10.0, "probes": 1,
            "spans": {"outer": [("SearchSession.step", 1.0, 9.0)]},
            "missing": {}, "device": None}


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


def test_the_share_of_outermost_fits_on_the_kernel(program):
    kernel, eager = {"kind": "linear", "path": "kernel"}, {"path": "eager"}
    # the classifier's fit nested in an eager span does not count
    program(_program([(kernel, None), (kernel, None), (kernel, None),
                      (eager, {"kind": "se", "path": "kernel"})]))
    assert READ(_record()) == pytest.approx(75.0)


@pytest.mark.parametrize("fits", [[], [({"kind": "linear"}, None)]])
def test_none_without_fits_or_their_path(program, fits):
    program(_program(fits))
    assert READ(_record()) is None
