"""Model geometry configs + registry.

A copy of ``fused4bit_tpu/models/config.py``: plain dataclasses, so both
packages describe a model with the same fields and the same registry.
``ModelConfig``'s fields past ``rms_eps`` are the port's own: they describe
decoders other than Mixtral's (a hidden size of their own, window layers,
leading dense layers, a shared expert, a sigmoid router limited to groups
of experts, the EXAONE 4.0 block, multi-head latent attention with YaRN
RoPE, a share of the experts), and their defaults leave a Mixtral config as
it was. ``MODEL_CONFIGS`` holds such models at their published widths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = [
    "MoEConfig",
    "ModelConfig",
    "BenchmarkConfig",
    "MIXTRAL_8x7B",
    "DEEPSEEK_V3",
    "GLM_5",
    "QWEN3_235B",
    "DEBUG_TINY",
    "ALL_CONFIGS",
    "MIXTRAL_BENCHMARK_CONFIGS",
    "get_config_by_name",
    "K_EXAONE_236B",
    "DEEPSEEK_V3_671B",
    "MODEL_CONFIGS",
    "YaRN",
    "port_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """MoE layer geometry (reference `config.py:34-63`)."""

    name: str
    num_experts: int
    hidden_dim: int
    ffn_dim: int
    top_k: int
    description: str = ""

    @property
    def total_expert_params(self) -> int:
        # Three projections per expert (gate/up/down, SwiGLU).
        return self.num_experts * 3 * self.hidden_dim * self.ffn_dim

    @property
    def active_expert_params(self) -> int:
        return self.top_k * 3 * self.hidden_dim * self.ffn_dim

    def memory_bytes(self, bits_per_weight: float = 4.0) -> int:
        return int(self.total_expert_params * bits_per_weight / 8)


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's RoPE scaling (``rope_scaling`` of type "yarn" in a Hugging Face
    config): the rotary frequencies stretched by ``factor`` below the
    correction range of ``beta_fast``/``beta_slow`` rotations over
    ``original_max_position_embeddings``, and the attention's softmax scale
    times ``mscale(factor, mscale_all_dim)`` squared."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full decoder geometry for the flagship model slice."""

    name: str
    moe: MoEConfig
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    vocab_size: int = 32000
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    # The port's own fields; the defaults are Mixtral's decoder.
    hidden_size: int = 0             # 0: num_heads * head_dim
    windows: Tuple[int, ...] = ()    # each layer's attention window, 0 full; (): all full
    dense_layers: int = 0            # the first layers' feed-forward is a dense SwiGLU ...
    dense_ffn: int = 0               # ... of this width
    shared_ffn: int = 0              # > 0: each MoE layer adds a shared SwiGLU expert
    router: str = "softmax"          # "sigmoid": sigmoid scores, top-k by score + bias
    routed_scale: float = 1.0        # the routed weights' factor after renormalizing
    block: str = "mixtral"           # "exaone4": QK-norm, RoPE on window layers, post-norms
    first_expert: int = 0            # the experts held here: [first_expert,
    held_experts: int = 0            #   first_expert + held_experts); 0: all of them
    n_group: int = 1                 # the sigmoid router picks experts inside the
    topk_group: int = 1              #   topk_group best of n_group groups
    q_lora_rank: int = 0             # multi-head latent attention (MLA): q's latent width ...
    kv_lora_rank: int = 0            # ... the cached latent c_KV's width (> 0: MLA) ...
    qk_nope_dim: int = 0             # ... a head's q/k width without RoPE, ...
    qk_rope_dim: int = 0             # ... with RoPE (one key of it shared by every head) ...
    v_head_dim: int = 0              # ... and a head's value width
    yarn: Optional[YaRN] = None      # MLA's RoPE scaling (None: plain RoPE)

    @property
    def hidden(self) -> int:
        return self.hidden_size or self.num_heads * self.head_dim

    @property
    def held(self) -> int:
        """The routed experts each MoE layer holds here."""
        return self.held_experts or self.moe.num_experts

    def window(self, layer: int) -> int:
        """Layer ``layer``'s attention window (0: full attention)."""
        return self.windows[layer] if self.windows else 0


def port_config(cfg) -> ModelConfig:
    """``cfg`` as the port's ``ModelConfig``: a config that has Mixtral's
    fields alone (the JAX package's) takes the defaults of the others."""
    if isinstance(cfg, ModelConfig):
        return cfg
    return ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
                          if hasattr(cfg, f.name)})


# Real geometries, matching reference `config.py:70-109`.
MIXTRAL_8x7B = MoEConfig(
    name="mixtral-8x7b",
    num_experts=8,
    hidden_dim=4096,
    ffn_dim=14336,
    top_k=2,
    description="Mixtral 8x7B MoE layer geometry",
)

DEEPSEEK_V3 = MoEConfig(
    name="deepseek-v3",
    num_experts=64,
    hidden_dim=4096,
    ffn_dim=11008,
    top_k=8,
    description="DeepSeek-V3-style fine-grained MoE",
)

GLM_5 = MoEConfig(
    name="glm-5",
    num_experts=128,
    hidden_dim=5120,
    ffn_dim=13696,
    top_k=8,
    description="GLM-5-style wide MoE",
)

QWEN3_235B = MoEConfig(
    name="qwen3-235b",
    num_experts=64,
    hidden_dim=4096,
    ffn_dim=11008,
    top_k=8,
    description="Qwen3-235B-style MoE",
)

DEBUG_TINY = MoEConfig(
    name="debug-tiny",
    num_experts=4,
    hidden_dim=512,
    ffn_dim=1024,
    top_k=2,
    description="Tiny geometry for tests/debugging",
)

ALL_CONFIGS: Dict[str, MoEConfig] = {
    c.name: c
    for c in (MIXTRAL_8x7B, DEEPSEEK_V3, GLM_5, QWEN3_235B, DEBUG_TINY)
}

# Short aliases accepted by the CLI (reference `config.py:162-176`).
_ALIASES = {
    "mixtral": "mixtral-8x7b",
    "deepseek": "deepseek-v3",
    "glm": "glm-5",
    "qwen": "qwen3-235b",
    "qwen3": "qwen3-235b",
    "debug": "debug-tiny",
    "tiny": "debug-tiny",
}


def get_config_by_name(name: str) -> MoEConfig:
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in ALL_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(ALL_CONFIGS)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return ALL_CONFIGS[key]


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    """One benchmark point (reference `config.py:117-159`)."""

    moe: MoEConfig
    batch_size: int = 16
    seq_len: int = 512
    warmup_iters: int = 5
    bench_iters: int = 20
    distribution: str = "uniform"

    @property
    def num_tokens(self) -> int:
        return self.batch_size * self.seq_len


MIXTRAL_BENCHMARK_CONFIGS: List[BenchmarkConfig] = [
    BenchmarkConfig(moe=MIXTRAL_8x7B, batch_size=b) for b in (1, 8, 16, 32)
]


def flagship_model_config(scale: str = "tiny") -> ModelConfig:
    """Mixtral-geometry decode model at several scales.

    `tiny` keeps tests fast; `full` is the real Mixtral-8x7B geometry
    (BASELINE.json configs[3]).
    """
    if scale == "full":
        return ModelConfig(name="mixtral-8x7b-int4", moe=MIXTRAL_8x7B)
    if scale == "small":
        return ModelConfig(
            name="mixtral-small-int4",
            moe=MoEConfig("mixtral-small", 8, 1024, 3584, 2),
            num_layers=4,
            num_heads=8,
            num_kv_heads=4,
            head_dim=128,
            vocab_size=8192,
            max_seq_len=1024,
        )
    if scale == "layer2":
        # 2 layers of the EXACT Mixtral-8x7B layer geometry (8 experts,
        # 4096->14336, top-2). The depth is the JAX package's cut, kept so
        # both packages serve the same model; vocab kept small so
        # embed/lm_head don't dominate.
        return ModelConfig(
            name="mixtral-layer2-int4",
            moe=MoEConfig("mixtral-layer2", 8, 4096, 14336, 2),
            num_layers=2,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            vocab_size=8192,
            max_seq_len=1024,
        )
    return ModelConfig(
        name="mixtral-tiny-int4",
        moe=DEBUG_TINY,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        vocab_size=512,
        max_seq_len=256,
    )


# K-EXAONE-236B-A23B (huggingface.co/LGAI-EXAONE/K-EXAONE-236B-A23B,
# config.json): 48 layers "LLLG" (36 window layers of 128 positions, 12
# full), 64 query and 8 KV heads of 128 at hidden 6144, layer 0 a dense
# SwiGLU of 18432, layers 1-47 128 experts of 2048 with top-8 sigmoid
# routing (normalized, x 2.5) and one shared expert. Its MTP layer is not
# held. ``dataclasses.replace(K_EXAONE_236B, held_experts=32)`` is one
# card's share of an EP4 host.
K_EXAONE_236B = ModelConfig(
    name="k-exaone-236b-a23b",
    moe=MoEConfig("k-exaone-236b-a23b", 128, 6144, 2048, 8,
                  description="K-EXAONE-236B-A23B MoE layer geometry"),
    num_layers=48, num_heads=64, num_kv_heads=8, head_dim=128, vocab_size=153600,
    max_seq_len=262144, rope_theta=1e6, rms_eps=1e-5, hidden_size=6144,
    windows=(128, 128, 128, 0) * 12, dense_layers=1, dense_ffn=18432, shared_ffn=2048,
    router="sigmoid", routed_scale=2.5, block="exaone4",
)

# DeepSeek-V3 (huggingface.co/deepseek-ai/DeepSeek-V3, config.json): 61
# layers of multi-head latent attention (128 heads; q through a latent of
# 1536, keys and values through a cached latent of 512 beside one shared
# 64-wide RoPE key; heads of 128 + 64 for q and k, 128 for v; YaRN RoPE x40
# over 4096 original positions) at hidden 7168; layers 0-2 dense SwiGLUs of
# 18432, layers 3-60 256 experts of 2048 with top-8 sigmoid routing inside the
# 4 best of 8 groups (normalized, x 2.5) and one shared expert. Its MTP layer
# is not held. ``dataclasses.replace(DEEPSEEK_V3_671B, held_experts=32)`` is
# one card's share of an EP8 host.
DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b",
    moe=MoEConfig("deepseek-v3-671b", 256, 7168, 2048, 8,
                  description="DeepSeek-V3 MoE layer geometry"),
    num_layers=61, num_heads=128, num_kv_heads=128, head_dim=192, vocab_size=129280,
    max_seq_len=163840, rope_theta=10000.0, rms_eps=1e-6, hidden_size=7168,
    dense_layers=3, dense_ffn=18432, shared_ffn=2048, router="sigmoid", routed_scale=2.5,
    n_group=8, topk_group=4, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    yarn=YaRN(factor=40.0, original_max_position_embeddings=4096, beta_fast=32.0,
              beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
)

MODEL_CONFIGS: Dict[str, ModelConfig] = {c.name: c for c in (K_EXAONE_236B, DEEPSEEK_V3_671B)}
