from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_large, bert_tiny)
from .gpt import GPTConfig, gpt_125m, gpt_tiny
from .llama import LlamaConfig, init_params, llama_7b, llama_tiny

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "bert_tiny", "bert_base", "bert_large",
           "GPTConfig", "gpt_125m", "gpt_tiny", "LlamaConfig",
           "init_params", "llama_7b", "llama_tiny"]
