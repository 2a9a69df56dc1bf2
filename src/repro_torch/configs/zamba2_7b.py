"""zamba2-7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
One SHARED transformer block (weights reused at every occurrence) every 6
positions — zamba2's hallmark; the rest are Mamba2 blocks.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2, chunk=128),
    hybrid_attn_every=6,
    act="swiglu",
    tie_embeddings=True,
    source="Zamba2 [arXiv:2411.15242]",
)
