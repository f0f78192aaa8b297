"""Models of the port: the Llama-class ``TransformerLM`` with its paged
KV cache, and BERT."""
from .bert import (BertConfig, BERTForPretrain, BERTModel,  # noqa: F401
                   bert_base_config, bert_tiny_config)
from .kv_cache import CacheSpec, CacheView, init_pools  # noqa: F401
from .transformer import (LlamaConfig, TransformerBlock,  # noqa: F401
                          TransformerLM, llama3_8b_config, tiny_config)
