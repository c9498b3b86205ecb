from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaConfig, LlamaForCausalLM, build_rope_cache,
                    load_numpy_optimizer_state, load_numpy_state)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "LlamaConfig",
           "LlamaForCausalLM", "build_rope_cache", "load_numpy_optimizer_state",
           "load_numpy_state"]
