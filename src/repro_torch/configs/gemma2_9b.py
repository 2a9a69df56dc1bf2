"""gemma2-9b — alternating local/global attention + logit softcaps [arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    layer_pattern="alt_local_global",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=224.0,   # d_model / n_heads, per the gemma2 report
    post_norms=True,
    act="gelu_glu",                # gemma's GeGLU
    tie_embeddings=True,
    source="Gemma 2 [arXiv:2408.00118]",
)
