from .gpt import GPTConfig, gpt_125m, gpt_tiny
from .llama import LlamaConfig, init_params, llama_7b, llama_tiny

__all__ = ["GPTConfig", "gpt_125m", "gpt_tiny", "LlamaConfig",
           "init_params", "llama_7b", "llama_tiny"]
