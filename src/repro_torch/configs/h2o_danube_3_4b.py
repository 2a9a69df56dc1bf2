"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    layer_pattern="swa",
    rope_theta=10000.0,
    act="swiglu",
    tie_embeddings=False,
    source="H2O-Danube [arXiv:2401.16818]",
)
