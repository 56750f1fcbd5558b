"""The prefix-scan substrate of the PyTorch port."""

from repro_torch.core import scan

__all__ = ["scan"]
