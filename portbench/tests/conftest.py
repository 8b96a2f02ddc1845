"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from the
repository's root. Tests marked ``cuda`` need the card and skip here."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips on the CPU")


@pytest.fixture(autouse=True)
def _no_onednn():
    """This CPU build's oneDNN computes some small convolutions wrongly; the
    plain kernels keep the CPU results exact."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield
