"""Config-derived analytic FLOPs, the JAX package's ``configs/flops.py``
(torch-free: the dry-run launcher and benchmarks both read it)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def analytic_flops_per_device(cfg: ModelConfig, shape: ShapeConfig,
                              n_devices: int) -> float:
    """The model's math per device: 2 x the matmul params x tokens, the
    logits matmul, and the attention scores and values (causal halves them
    outside decode); a train step is 4 x the forward (forward, backward at
    2 x, and one recompute of the forward)."""
    B = shape.global_batch
    S = shape.seq_len
    tokens = B * (1 if shape.mode == "decode" else S)
    V, D = cfg.vocab_size, cfg.d_model
    embed = V * D * (1 if cfg.tie_embeddings else 2)
    mm = cfg.n_active_params() - embed          # matmul-ish params
    head = D * V                                # logits matmul
    fwd = 2.0 * (mm * tokens + head * tokens)
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("dense", "moe", "shared_attn"))
    hd = cfg.resolved_head_dim
    skv = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
    if shape.mode == "decode":
        fwd += 4.0 * B * skv * cfg.n_heads * hd * n_attn
    else:
        fwd += 4.0 * B * S * skv * cfg.n_heads * hd * n_attn / 2  # causal
    if shape.mode == "train":
        return 4.0 * fwd / n_devices
    return fwd / n_devices
