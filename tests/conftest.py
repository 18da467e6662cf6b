"""Tier-1 test harness hooks.

When ``REPRO_LOCKCHECK=1``, install the runtime lock-order sanitizer
(repro.lint.runtime) before any test module imports threading users,
and fail the session if any lock-order inversion was recorded.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro.lint import runtime  # noqa: E402

_LOCKCHECK = runtime.install()  # no-op unless REPRO_LOCKCHECK=1


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    if not _LOCKCHECK:
        return
    inv = runtime.inversions()
    rep = runtime.report()
    terminalreporter.write_line(
        f"repro.lint.runtime: {len(rep.edges)} lock-order edge(s) observed, "
        f"{len(inv)} inversion(s)"
    )
    for i in inv:
        terminalreporter.write_line(f"  INVERSION: {i['first']}  vs  {i['second']}")


def pytest_sessionfinish(session, exitstatus):
    if _LOCKCHECK and runtime.inversions():
        session.exitstatus = 3
        print(
            "repro.lint.runtime: lock-order inversion(s) recorded — failing "
            "the session (REPRO_LOCKCHECK=1)",
            file=sys.stderr,
        )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (Hopper) and nvcc; skips without")
