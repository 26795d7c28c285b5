import pytest
import torch


@pytest.fixture
def card():
    """The card, or a skip: the decision is made when a test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
