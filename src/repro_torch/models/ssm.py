"""RWKV6 ("Finch"): attention-free layers with data-dependent decay and
token shift.

Two forms, as in the JAX package (``models/ssm.py``): the chunked time-mix
for prefill, whose recurrence runs through ``kernels/wkv6`` (the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor), and the
single-token step for decode, a few plain tensor ops. Both take and return
the layer's state: the WKV state S [B, nh, hd, hd] in fp32 and the token
shift [B, 1, D]. Mamba2 is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swap_linear_q import activation
from repro_torch.kernels.wkv6 import CHUNK as RWKV_CHUNK  # noqa: F401
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import layer_norm, linear
from repro_torch.models.params import ParamDef

# per-step log-decay clamped to [W_LOG_MIN, W_LOG_MAX]; with chunk size
# Q = RWKV_CHUNK, |cumulative| <= Q * |W_LOG_MIN| must stay < log(float32
# max) ~ 88
W_LOG_MIN = -5.0
W_LOG_MAX = -1e-4


def rwkv6_dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd                   # (n_heads, head_dim)


def rwkv6_defs(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    nh, hd = rwkv6_dims(cfg)
    lora = 64
    return {
        "ln1_w": ParamDef((D,), init="ones"),
        "ln1_b": ParamDef((D,), init="zeros"),
        "ln2_w": ParamDef((D,), init="ones"),
        "ln2_b": ParamDef((D,), init="zeros"),
        # time-mix token-shift interpolators
        "mu_r": ParamDef((D,), init="small"),
        "mu_k": ParamDef((D,), init="small"),
        "mu_v": ParamDef((D,), init="small"),
        "mu_g": ParamDef((D,), init="small"),
        "mu_w": ParamDef((D,), init="small"),
        # data-dependent decay lora
        "w_base": ParamDef((D,), init="zeros"),
        "w_lora_a": ParamDef((D, lora), init="small"),
        "w_lora_b": ParamDef((lora, D), init="small"),
        "wr": ParamDef((D, D)),
        "wk": ParamDef((D, D)),
        "wv": ParamDef((D, D)),
        "wg": ParamDef((D, D)),
        "u": ParamDef((nh, hd), init="small"),
        "ln_x_w": ParamDef((D,), init="ones"),
        "ln_x_b": ParamDef((D,), init="zeros"),
        "wo": ParamDef((D, D)),
        # channel mix
        "mu_ck": ParamDef((D,), init="small"),
        "mu_cr": ParamDef((D,), init="small"),
        "ck": ParamDef((D, F)),
        "cv": ParamDef((F, D)),
        "cr": ParamDef((D, D)),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x[t] -> x[t-1]; prev [B, 1, D] seeds position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_time_inputs(cfg: ModelConfig, p: dict, xn: torch.Tensor,
                      shift_prev: Optional[torch.Tensor]):
    """Projections for the time-mix half. xn is post-ln1. r, k, v and the
    log decay come back fp32 [B, S, nh, hd]."""
    nh, hd = rwkv6_dims(cfg)
    B, S, D = xn.shape
    xp = _shift(xn, shift_prev)

    def lerp(mu):
        return xn + (xp - xn) * mu
    r = (lerp(p["mu_r"]) @ p["wr"]).reshape(B, S, nh, hd).to(torch.float32)
    k = (lerp(p["mu_k"]) @ p["wk"]).reshape(B, S, nh, hd).to(torch.float32)
    v = (lerp(p["mu_v"]) @ p["wv"]).reshape(B, S, nh, hd).to(torch.float32)
    g = activation(lerp(p["mu_g"]) @ p["wg"], "silu")
    w_log = (p["w_base"]
             + torch.tanh(lerp(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"])
    logw = torch.clamp(-torch.exp(w_log.to(torch.float32)), W_LOG_MIN,
                       W_LOG_MAX).reshape(B, S, nh, hd)
    return r, k, v, g, logw, xn[:, -1:]


def _time_mix_out(p: dict, y: torch.Tensor, g: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
    y = layer_norm(y, p["ln_x_w"], p["ln_x_b"], eps=1e-5)
    return linear(y.to(dt) * g, p["wo"])


def rwkv6_time_mix_chunked(cfg: ModelConfig, p: dict, xn: torch.Tensor,
                           S0: Optional[torch.Tensor] = None,
                           shift_prev: Optional[torch.Tensor] = None):
    """xn [B, S, D] (post-ln1). Returns (out [B, S, D], (S [B, nh, hd, hd]
    fp32, shift [B, 1, D])). S must be at most 16 or a multiple of 16:
    ``wkv6`` raises ValueError where the JAX package asserts."""
    nh, hd = rwkv6_dims(cfg)
    B, S, D = xn.shape
    r, k, v, g, logw, shift_out = _rwkv_time_inputs(cfg, p, xn, shift_prev)

    def rows(t):                    # [B, S, nh, hd] -> [BH, S, hd]
        return t.transpose(1, 2).reshape(B * nh, S, hd).contiguous()
    u = p["u"].to(torch.float32).expand(B, nh, hd).reshape(B * nh, hd)
    state = None if S0 is None else \
        S0.to(torch.float32).reshape(B * nh, hd, hd).contiguous()
    y, S_fin = wkv6(rows(r), rows(k), rows(v), rows(logw), u.contiguous(),
                    state)
    y = y.reshape(B, nh, S, hd).transpose(1, 2).reshape(B, S, D)
    return (_time_mix_out(p, y, g, xn.dtype),
            (S_fin.reshape(B, nh, hd, hd), shift_out))


def rwkv6_time_mix_step(cfg: ModelConfig, p: dict, xn: torch.Tensor,
                        Scur: torch.Tensor, shift_prev: torch.Tensor):
    """Single token. xn [B, 1, D]; Scur [B, nh, hd, hd]; shift_prev
    [B, 1, D]. Returns (out, (S_new, shift))."""
    B = xn.shape[0]
    r, k, v, g, logw, shift_out = _rwkv_time_inputs(cfg, p, xn, shift_prev)
    rq, kq, vq, lw = r[:, 0], k[:, 0], v[:, 0], logw[:, 0]   # [B, nh, hd]
    bonus = torch.einsum("bnh,bnh->bn", rq, p["u"][None] * kq)
    y = torch.einsum("bnh,bnhv->bnv", rq, Scur) + bonus[..., None] * vq
    S_new = torch.exp(lw)[..., None] * Scur + kq[..., None] * vq[..., None, :]
    y = y.reshape(B, 1, cfg.d_model)
    return _time_mix_out(p, y, g, xn.dtype), (S_new, shift_out)


def rwkv6_channel_mix(cfg: ModelConfig, p: dict, xn: torch.Tensor,
                      shift_prev: Optional[torch.Tensor] = None):
    """xn [B, S, D] (post-ln2). Returns (out, shift state)."""
    xp = _shift(xn, shift_prev)
    xk = xn + (xp - xn) * p["mu_ck"]
    xr = xn + (xp - xn) * p["mu_cr"]
    h = torch.square(torch.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (h @ p["cv"]), xn[:, -1:]
