"""qwen2.5-3b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family card].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    attn_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    tie_embeddings=True,
    source="Qwen2.5 [hf:Qwen/Qwen2.5-0.5B]",
)
