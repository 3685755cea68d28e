"""A tiny checkout of the benchmark, made once per test session."""

import pytest

from . import tiny


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
