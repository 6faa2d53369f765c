"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — tests must see the
real single CPU device; only launch/dryrun.py forces 512 host devices."""
import pathlib
import sys

import numpy as np
import pytest

try:                                    # real hypothesis when installed...
    import hypothesis                   # noqa: F401
except ModuleNotFoundError:             # ...seeded fallback otherwise
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import _hypothesis_fallback
    _hypothesis_fallback.install()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA); skipped without one")
