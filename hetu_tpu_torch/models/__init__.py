"""Model code of the PyTorch port: the GPT config, the GPT decode cores
(``gpt_decode``) with their MoE variant (``moe_decode``) and the
trainable GPT (``gpt``)."""

from .gpt import GPTBlock, GPTForCausalLM, GPTModel  # noqa: F401
from .gpt_config import GPTConfig  # noqa: F401
from .moe_decode import (MoEDecodeConfig, MoESpec,  # noqa: F401
                         convert_dense_to_moe, init_moe_params,
                         moe_capacity, moe_ffn, moe_spec_of,
                         resolve_moe_capacity)

__all__ = ["GPTBlock", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "MoEDecodeConfig", "MoESpec", "convert_dense_to_moe",
           "init_moe_params", "moe_capacity", "moe_ffn", "moe_spec_of",
           "resolve_moe_capacity"]
