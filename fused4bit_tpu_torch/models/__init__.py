from .config import ModelConfig, MoEConfig, flagship_model_config, get_config_by_name
from .convert import (
    SeededCheckpoint,
    checkpoint_shapes,
    convert_checkpoint,
    convert_safetensors,
    quantize_dense_2d,
)
from .dense_baseline import (
    DenseBlock,
    DenseKVCache,
    DenseTransformer,
    dense_from_params,
    dense_from_quantized,
)
from .from_jax import kv_cache_from_jax, model_from_jax
from .safetensors_io import load_safetensors, save_safetensors
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
    "DenseBlock",
    "DenseKVCache",
    "DenseTransformer",
    "ModelConfig",
    "MoEBlock",
    "MoEConfig",
    "QuantizedTransformer",
    "SeededCheckpoint",
    "TransformerBlock",
    "as_per_group",
    "as_turbo",
    "as_u4_turbo",
    "as_xla_turbo",
    "checkpoint_shapes",
    "convert_checkpoint",
    "convert_safetensors",
    "dense_from_params",
    "dense_from_quantized",
    "flagship_model_config",
    "get_config_by_name",
    "kv_cache_from_jax",
    "load_safetensors",
    "model_from_jax",
    "quantize_dense_2d",
    "rms_norm",
    "rotary_embedding",
    "save_safetensors",
]
