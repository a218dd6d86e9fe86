"""Model code of the PyTorch port: the GPT config and the dense GPT
decode cores (``gpt_decode``)."""

from .gpt_config import GPTConfig  # noqa: F401

__all__ = ["GPTConfig"]
