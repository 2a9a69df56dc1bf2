"""Architecture registry: --arch <id> resolves here."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.configs.shapes import SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K

from repro_torch.configs import (
    granite_20b,
    rwkv6_3b,
    qwen2_vl_72b,
    qwen2_5_3b,
    zamba2_7b,
    hubert_xlarge,
    h2o_danube_3_4b,
    gemma2_9b,
    deepseek_v2_lite_16b,
    llama4_scout_17b,
)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_20b, rwkv6_3b, qwen2_vl_72b, qwen2_5_3b, zamba2_7b,
        hubert_xlarge, h2o_danube_3_4b, gemma2_9b, deepseek_v2_lite_16b,
        llama4_scout_17b,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def applicable(arch: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) runs, per DESIGN.md §5 skip rules."""
    if shape.mode == "decode":
        if not arch.supports_decode():
            return False
        if shape.seq_len > 100_000 and not arch.supports_long_context():
            return False
    return True


__all__ = ["ModelConfig", "ShapeConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "ARCHS", "get_arch", "get_shape", "applicable"]
