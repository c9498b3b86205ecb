from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel,
                    ernie_pretrain_step)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, apply_rope,
                    build_rope_cache, load_numpy_optimizer_state,
                    load_numpy_state)
from .unet import UNet2DConditionModel, UNetConfig

__all__ = ["ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieModel",
           "ernie_pretrain_step", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "apply_rope",
           "build_rope_cache",
           "load_numpy_optimizer_state", "load_numpy_state",
           "UNet2DConditionModel", "UNetConfig"]
