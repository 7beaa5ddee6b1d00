"""Shared fixtures.

The Backend registry (core/convcore.BACKENDS) is process-global; tests
that register sharded backends (the scheduler differentials) used to leak
them into every later test.  Snapshot/restore it around each test so no
registration escapes its test, whatever the test itself does.
"""

import pytest

from repro.core import convcore


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: launches a CUDA kernel of repro_torch; skips "
        "where no NVIDIA GPU is present")


@pytest.fixture(autouse=True)
def _clean_backend_registry():
    snapshot = dict(convcore.BACKENDS)
    yield
    convcore.BACKENDS.clear()
    convcore.BACKENDS.update(snapshot)
