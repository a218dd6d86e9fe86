"""Model code of the PyTorch port: the GPT config, the dense GPT
decode cores (``gpt_decode``) and the trainable GPT (``gpt``)."""

from .gpt import GPTBlock, GPTForCausalLM, GPTModel  # noqa: F401
from .gpt_config import GPTConfig  # noqa: F401

__all__ = ["GPTBlock", "GPTConfig", "GPTForCausalLM", "GPTModel"]
