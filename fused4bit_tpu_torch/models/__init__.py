from .config import ModelConfig, MoEConfig, flagship_model_config, get_config_by_name
from .from_jax import kv_cache_from_jax, model_from_jax
from .transformer import (
    Attention,
    MoEBlock,
    QuantizedTransformer,
    TransformerBlock,
    as_per_group,
    as_turbo,
    as_u4_turbo,
    as_xla_turbo,
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
    "as_per_group",
    "as_turbo",
    "as_u4_turbo",
    "as_xla_turbo",
    "flagship_model_config",
    "get_config_by_name",
    "kv_cache_from_jax",
    "model_from_jax",
    "rms_norm",
    "rotary_embedding",
]
