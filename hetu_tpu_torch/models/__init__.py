"""Model code of the PyTorch port: the GPT config, the GPT decode cores
(``gpt_decode``) with their MoE variant (``moe_decode``), the trainable
``nn.Module`` GPT (``gpt_module``), and the JAX package's model zoo on
the graph surface under its names: GPT (``gpt``), the CNN family
(``cnn``), BERT (``bert``) and
BERT-MoE (``bert_moe``), the MT Transformer (``transformer``), the CTR
models (``ctr``), NCF (``ncf``) and the MoE models (``moe_models``).
The zoo's functions and classes build graph nodes
(``hetu_tpu_torch.graph``)."""

from .cnn import (  # noqa: F401
    mlp, logreg, cnn_3_layers, lenet, alexnet, vgg, vgg16, vgg19,
    resnet, resnet18, resnet34, resnet50, resnet101, resnet152,
    rnn, lstm, fc,
)
from .bert import (  # noqa: F401
    BertConfig, BertModel, BertForPreTraining,
    BertForSequenceClassification, BertForMaskedLM,
    BertForQuestionAnswering,
)
from .bert_moe import (  # noqa: F401
    BertMoEConfig, BertMoEModel, BertMoEForPreTraining,
)
from .transformer import TransformerConfig, Transformer, \
    transformer_mt  # noqa: F401
from .gpt import (GPTBlock, GPTForCausalLM, GPTModel,  # noqa: F401
                  greedy_generate)
from .gpt_module import (GPTBlockModule, GPTForCausalLMModule,  # noqa: F401
                         GPTModelModule, greedy_generate_module)
from .gpt_config import GPTConfig  # noqa: F401
from .ctr import (  # noqa: F401
    wdl_adult, wdl_criteo, dcn_criteo, deepfm_criteo, dc_criteo,
)
from .ncf import neural_mf  # noqa: F401
from .moe_models import moe_mlp, moe_transformer_block  # noqa: F401
from .moe_decode import (  # noqa: F401
    MoEDecodeConfig, MoESpec, moe_spec_of, moe_capacity, moe_ffn,
    moe_ffn_ep_reference, ep_shard_params, init_moe_params,
    convert_dense_to_moe, resolve_moe_capacity, resolve_moe_quant,
)

__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("cnn", "bert", "bert_moe", "transformer", "gpt",
                         "gpt_config", "gpt_decode", "gpt_module", "ctr", "ncf",
                         "moe_models", "moe_decode")]
