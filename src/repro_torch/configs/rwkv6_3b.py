"""rwkv6-3b — Finch, attention-free RNN with data-dependent decay [arXiv:2404.05892].

32L d_model=2560 d_ff=8960 vocab=65536; WKV6 head size 64 -> 40 heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # WKV heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    rope_type="none",
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64, chunk=128),
    act="relu_sq",       # rwkv channel-mix uses squared relu
    tie_embeddings=False,
    # data-dependent decay: the WKV recurrence compounds per-step weight
    # error across the sequence, so int8 swap units are not worth the I/O
    quant_eligible=False,
    source="RWKV-6 Finch [arXiv:2404.05892]",
)
