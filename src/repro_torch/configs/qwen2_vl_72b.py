"""qwen2-vl-72b — VLM with M-RoPE and dynamic resolution [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. Vision encoder
(ViT-675M) is a frontend STUB per the brief: input_specs() provides patch
embeddings at the projector output dim; we build the LM backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim/2 = 64
    rope_theta=1_000_000.0,
    n_vision_tokens=1024,          # stub patch-embedding count per sample
    d_frontend=1280,               # ViT output dim before projector
    act="swiglu",
    tie_embeddings=False,
    source="Qwen2-VL [arXiv:2409.12191]",
)
