"""hubert-xlarge — encoder-only audio model [arXiv:2106.07447].

48L d_model=1280 16H d_ff=5120 vocab=504 (k-means cluster targets).
Conv feature extractor (mel frontend) is a STUB per the brief: input_specs()
provides frame embeddings (B, S, d_frontend); we build the encoder backbone
and the masked-prediction head. Encoder-only: no decode shapes.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    rope_type="none",      # hubert uses conv positional embedding (folded into stub)
    is_encoder=True,
    embed_inputs=False,
    d_frontend=512,        # conv extractor output dim
    act="gelu",
    tie_embeddings=False,
    # masked-prediction targets are nearest-neighbour cluster ids: logit
    # margins are tight, so this model opts out of int8 swap units
    quant_eligible=False,
    source="HuBERT [arXiv:2106.07447]",
)
