"""llama4-scout-17b-a16e — MoE (16 routed top-1 + 1 shared), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192(per expert) vocab=202048.
Vision (early-fusion) frontend is a STUB: input_specs() provides patch
embeddings; we build the MoE LM backbone. iRoPE-style attention: 3 of every
4 layers attend block-locally (8192-token chunks), every 4th is global —
this is what makes long_500k decode sub-quadratic per layer. (Deviation:
global layers keep RoPE rather than NoPE.)
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    attn_chunk=8192,
    layer_pattern="chunked",
    moe=MoEConfig(n_routed=16, top_k=1, n_shared=1,
                  d_expert=8192, d_shared=8192),
    n_vision_tokens=1024,
    d_frontend=1408,
    act="swiglu",
    tie_embeddings=False,
    source="Llama 4 Scout [hf:meta-llama/Llama-4-Scout-17B-16E]",
)
