from .train_step import build_llama_train_step

__all__ = ["build_llama_train_step"]
