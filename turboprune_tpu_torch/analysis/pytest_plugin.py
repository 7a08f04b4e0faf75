"""Pytest integration for graftsan (sanitizer.py).

``graftsan`` is a fixture, not an autouse hook: a test opts in, drives
whatever concurrent machinery it wants through the package's real code
paths, and gets the observed lock-order graph and write log to assert on.
At teardown the fixture fails the test on any observed lock-order cycle —
the property no test should ever waive — while race verdicts are left to
the test body (the CLI's ``--sanitize`` owns the static-diff contract).

A test module imports it by name
(``from turboprune_tpu_torch.analysis.pytest_plugin import graftsan``);
in that module it stands in for any fixture of the same name.
"""

from __future__ import annotations

import pytest

from .sanitizer import Graftsan


@pytest.fixture
def graftsan():
    """Yields an ACTIVE Graftsan (factories patched); asserts zero observed
    lock-order cycles at teardown."""
    san = Graftsan()
    with san:
        yield san
    cycles = san.cycles()
    assert not cycles, f"graftsan observed lock-order cycle(s): {cycles}"
