from .train_step import build_gpt_train_step, build_llama_train_step

__all__ = ["build_gpt_train_step", "build_llama_train_step"]
