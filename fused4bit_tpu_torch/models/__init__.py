from .config import ModelConfig, MoEConfig, flagship_model_config, get_config_by_name
from .from_jax import kv_cache_from_jax, model_from_jax
from .transformer import (
    Attention,
    MoEBlock,
    QuantizedTransformer,
    TransformerBlock,
    rms_norm,
    rotary_embedding,
)

__all__ = [
    "Attention",
    "ModelConfig",
    "MoEBlock",
    "MoEConfig",
    "QuantizedTransformer",
    "TransformerBlock",
    "flagship_model_config",
    "get_config_by_name",
    "kv_cache_from_jax",
    "model_from_jax",
    "rms_norm",
    "rotary_embedding",
]
