"""Shared pytest configuration: pinned hypothesis profiles.

Property tests (``tests/test_property.py`` and the hypothesis-driven
cases elsewhere) must not be able to flake the CI gate: the ``ci``
profile derandomizes example generation (every run draws the same
examples) and disables deadlines (shared runners stall unpredictably).
It is selected automatically when ``CI`` is set in the environment —
GitHub Actions always sets it — and can be forced locally with
``pytest --hypothesis-profile=ci`` (or ``dev`` to explore fresh random
examples, the local default).

Hypothesis itself stays optional, exactly like the tests that use it
(``pytest.importorskip``): without it this module is a no-op.
"""
import os

try:
    from hypothesis import HealthCheck, settings
except ImportError:                                    # pragma: no cover
    pass
else:
    settings.register_profile(
        "ci",
        derandomize=True,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    settings.register_profile("dev", deadline=None)
    settings.load_profile("ci" if os.environ.get("CI") else "dev")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
