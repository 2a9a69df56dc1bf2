"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention [arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408(per expert) vocab=102400.
MLA kv_lora_rank=512; 2 shared + 64 routed experts, top-6.
(The assignment line lists "64e top-6" with a "160 routed" note; we follow the
64-routed figure, which matches the published V2-Lite card.)
"""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=64, top_k=6, n_shared=2,
                  d_expert=1408, d_shared=2816),
    act="swiglu",
    tie_embeddings=False,
    source="DeepSeek-V2(-Lite) [arXiv:2405.04434]",
)
