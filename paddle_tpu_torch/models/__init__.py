from .llama import (LlamaConfig, LlamaForCausalLM, build_rope_cache,
                    load_numpy_state)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_rope_cache",
           "load_numpy_state"]
