"""granite-20b — dense llama-arch code model [arXiv:2405.04324].

52L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10000.0,
    act="gelu",   # gpt_bigcode-style MLP per the granite-20b-code card
    tie_embeddings=False,
    swap_precision="int4",  # big dense feed-forward stacks tolerate 4-bit
                            # per-channel weights (GPTQ-regime); halves the
                            # swap bytes of the quantized store again
    source="IBM Granite Code Models [arXiv:2405.04324]",
)
