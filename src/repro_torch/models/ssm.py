"""State-space layers: Mamba2 (chunked SSD) and RWKV6 ("Finch").

Both ship two forms, as in the JAX package (``models/ssm.py``): a chunked
form for prefill and a single-token step for decode, each taking and
returning the layer's state.

Mamba2 (zamba2's blocks): the state is h [B, nh, hd, ds] in fp32 and the
causal conv's tail [B, d_conv - 1, d_inner + 2 ds] in the compute dtype.
The JAX package computes the SSD in jnp with no Pallas kernel, so here it
is plain tensor ops with the reference's arithmetic: chunks of
``Q = min(cfg.ssm.chunk, S)`` (S must be a multiple of Q), the decay as a
cumulative sum of ``log(max(a, 1e-37))``, fp32 for x, B, C, dt, the state
and the decay, each chunk's y cast to the compute dtype, then ``D_skip``
added in fp32 and the gated ``rms_norm``. The input projections (wz, wx,
wB, wC, wdt) are ``torch.matmul``, as the reference computes them outside
any kernel; ``wo`` goes through ``layers.linear`` (``swap_linear``, or
``swap_linear_q`` on a quantized store's weight).

RWKV6: attention-free layers with data-dependent decay and token shift.
The chunked time-mix's recurrence runs through ``kernels/wkv6`` (the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor; in training
through ``WKV6Fn``, whose backward ``wkv6_grad`` is torch ops, as the
reference trains through XLA's autodiff of its jnp chunk body); the step
is a few plain tensor ops. The state is the WKV state S [B, nh, hd, hd] in
fp32 and the token shift [B, 1, D]. On a device mesh (DTensor inputs)
``wkv6`` runs on each device's local batch shard.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (as_dtensor, batch_layout,
                                              batch_placements, is_dtensor,
                                              run_local)
from repro_torch.kernels.swap_linear_q import activation
from repro_torch.kernels.wkv6 import CHUNK as RWKV_CHUNK  # noqa: F401
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import layer_norm, linear, rms_norm
from repro_torch.models.params import ParamDef

# ==========================================================================
# Mamba2
# ==========================================================================
def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B, S, C], w [K, C]; state [B, K-1, C]
    (the previous tail). Returns (y [B, S, C], new state [B, K-1, C])."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                # [B, S+K-1, C]
    y = sum(xp[:, k:k + S] * w[k] for k in range(K))
    return y, (xp[:, -(K - 1):] if K > 1 else
               torch.zeros((B, 0, C), dtype=x.dtype, device=x.device))


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state   # (d_inner, nh, ds)


def mamba2_defs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    d_inner, nh, ds = mamba2_dims(cfg)
    return {
        "norm": ParamDef((D,), (None,), init="ones"),
        "wz": ParamDef((D, d_inner), ("residual", "tp")),
        "wx": ParamDef((D, d_inner), ("residual", "tp")),
        "wB": ParamDef((D, ds), ("residual", None)),
        "wC": ParamDef((D, ds), ("residual", None)),
        "wdt": ParamDef((D, nh), ("residual", "tp")),
        # the reference draws it at scale 0.5: fan_in ** -0.5 at d_conv 4
        "conv_w": ParamDef((s.d_conv, d_inner + 2 * ds), (None, None)),
        "A_log": ParamDef((nh,), ("tp",), init="zeros"),
        "dt_bias": ParamDef((nh,), ("tp",), init="zeros"),
        "D_skip": ParamDef((nh,), ("tp",), init="ones"),
        "norm_y": ParamDef((d_inner,), (None,), init="ones"),
        "wo": ParamDef((d_inner, D), ("tp", "residual")),
    }


def _mamba2_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   conv_state: Optional[torch.Tensor]):
    """The projections and the causal conv. x [B, S, D]. Returns z, xs
    [B, S, nh, hd], B and C [B, S, ds] (compute dtype), dt and the decay
    a [B, S, nh] (fp32) and the conv's new state."""
    d_inner, nh, ds = mamba2_dims(cfg)
    B, S, D = x.shape
    z = x @ p["wz"]
    xbc = torch.cat([x @ p["wx"], x @ p["wB"], x @ p["wC"]], dim=-1)
    xbc, new_conv = conv1d_causal(xbc, p["conv_w"], conv_state)
    xbc = activation(xbc, "silu")
    xs = xbc[..., :d_inner].reshape(B, S, nh, cfg.ssm.head_dim)
    Bv = xbc[..., d_inner:d_inner + ds]
    Cv = xbc[..., d_inner + ds:]
    r = (x @ p["wdt"]).to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(r, torch.zeros_like(r))       # softplus
    a = torch.exp(dt * (-torch.exp(p["A_log"].to(torch.float32))))
    z, xs, Bv, Cv, dt, a = batch_layout(z, xs, Bv, Cv, dt, a, decode=S == 1)
    return z, xs, Bv, Cv, dt, a, new_conv


def _mamba2_out(cfg: ModelConfig, p: dict, y: torch.Tensor,
                z: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The gated norm and ``wo``. y [B, S, d_inner] fp32."""
    y = rms_norm(y * activation(z.to(torch.float32), "silu"), p["norm_y"],
                 cfg.norm_eps)
    return linear(y.to(dt), p["wo"])


def mamba2_chunked(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   conv_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x [B, S, D] -> (y [B, S, D], (h [B, nh, hd, ds] fp32,
    conv state)). S must be a multiple of ``min(cfg.ssm.chunk, S)``:
    ValueError where the JAX package asserts."""
    d_inner, nh, ds = mamba2_dims(cfg)
    hd = cfg.ssm.head_dim
    B, S, D = x.shape
    Q = min(cfg.ssm.chunk, S)
    if S % Q:
        raise ValueError(f"mamba2 runs whole chunks of {Q} tokens: S={S} "
                         f"is not a multiple")
    z, xs, Bv, Cv, dt, a, new_conv = _mamba2_inputs(cfg, p, x, conv_state)
    h = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    idx = torch.arange(Q, device=x.device)
    causal = idx[:, None] >= idx[None, :]             # i <= t
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq = xs[:, sl].to(torch.float32)              # [B, Q, nh, hd]
        Bq = Bv[:, sl].to(torch.float32)              # [B, Q, ds]
        Cq = Cv[:, sl].to(torch.float32)
        dtq, aq = dt[:, sl], a[:, sl]                 # [B, Q, nh]
        l = torch.cumsum(torch.log(torch.clamp(aq, min=1e-37)), dim=1)
        # intra-chunk: M[t, i, n] = (C_t . B_i) exp(l_t - l_i) dt_i, i <= t
        cb = torch.einsum("btd,bid->bti", Cq, Bq)
        # the exponent masked before exp: above the diagonal l_t - l_i > 0
        # overflows to inf at strong decays, and backward's inf * 0 there
        # would make every gradient NaN (the reference exps it unmasked)
        ratio = torch.exp(torch.where(causal[None, :, :, None],
                                      l[:, :, None, :] - l[:, None, :, :],
                                      -torch.inf))
        M = cb[..., None] * ratio * dtq[:, None, :, :]
        M = torch.where(causal[None, :, :, None], M, 0.0)
        y_intra = torch.einsum("btin,binh->btnh", M, xq)
        # inter-chunk: y_t += exp(l_t) C_t . h
        y_inter = torch.einsum("btd,bnhd,btn->btnh", Cq, h, torch.exp(l))
        # h' = exp(l_Q) h + sum_i exp(l_Q - l_i) dt_i x_i B_i^T
        w_state = torch.exp(l[:, -1:, :] - l) * dtq   # [B, Q, nh] <= 1
        h = (torch.exp(l[:, -1])[:, :, None, None] * h
             + torch.einsum("btnh,btd,btn->bnhd", xq, Bq, w_state))
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = (y.to(torch.float32) + xs.to(torch.float32) * p["D_skip"][:, None]
         ).reshape(B, S, d_inner)
    return _mamba2_out(cfg, p, y, z, x.dtype), (h, new_conv)


def mamba2_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                h: torch.Tensor, conv_state: torch.Tensor):
    """Single-token decode. x [B, 1, D], h [B, nh, hd, ds], conv_state
    [B, K-1, C]. Returns (out, (h, conv state))."""
    d_inner, nh, ds = mamba2_dims(cfg)
    B = x.shape[0]
    z, xs, Bv, Cv, dt, a, new_conv = _mamba2_inputs(cfg, p, x, conv_state)
    xq = xs[:, 0].to(torch.float32)                   # [B, nh, hd]
    Bq = Bv[:, 0].to(torch.float32)                   # [B, ds]
    Cq = Cv[:, 0].to(torch.float32)
    dtq, aq = dt[:, 0], a[:, 0]                       # [B, nh]
    h = aq[:, :, None, None] * h + torch.einsum("bnh,bd,bn->bnhd", xq, Bq,
                                                dtq)
    y = torch.einsum("bnhd,bd->bnh", h, Cq) + xq * p["D_skip"][:, None]
    return (_mamba2_out(cfg, p, y.reshape(B, 1, d_inner), z, x.dtype),
            (h, new_conv))


# ==========================================================================
# RWKV6
# ==========================================================================
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
        "ln1_w": ParamDef((D,), (None,), init="ones"),
        "ln1_b": ParamDef((D,), (None,), init="zeros"),
        "ln2_w": ParamDef((D,), (None,), init="ones"),
        "ln2_b": ParamDef((D,), (None,), init="zeros"),
        # time-mix token-shift interpolators
        "mu_r": ParamDef((D,), (None,), init="small"),
        "mu_k": ParamDef((D,), (None,), init="small"),
        "mu_v": ParamDef((D,), (None,), init="small"),
        "mu_g": ParamDef((D,), (None,), init="small"),
        "mu_w": ParamDef((D,), (None,), init="small"),
        # data-dependent decay lora
        "w_base": ParamDef((D,), (None,), init="zeros"),
        "w_lora_a": ParamDef((D, lora), ("residual", None), init="small"),
        "w_lora_b": ParamDef((lora, D), (None, None), init="small"),
        "wr": ParamDef((D, D), ("residual", "tp")),
        "wk": ParamDef((D, D), ("residual", "tp")),
        "wv": ParamDef((D, D), ("residual", "tp")),
        "wg": ParamDef((D, D), ("residual", "tp")),
        "u": ParamDef((nh, hd), (None, None), init="small"),
        "ln_x_w": ParamDef((D,), (None,), init="ones"),
        "ln_x_b": ParamDef((D,), (None,), init="zeros"),
        "wo": ParamDef((D, D), ("tp", "residual")),
        # channel mix
        "mu_ck": ParamDef((D,), (None,), init="small"),
        "mu_cr": ParamDef((D,), (None,), init="small"),
        "ck": ParamDef((D, F), ("residual", "tp")),
        "cv": ParamDef((F, D), ("tp", "residual")),
        "cr": ParamDef((D, D), ("residual", "tp")),
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
    r, k, v, w_log = batch_layout(
        lerp(p["mu_r"]) @ p["wr"], lerp(p["mu_k"]) @ p["wk"],
        lerp(p["mu_v"]) @ p["wv"],
        p["w_base"] + torch.tanh(lerp(p["mu_w"]) @ p["w_lora_a"])
        @ p["w_lora_b"], decode=S == 1)
    r = r.reshape(B, S, nh, hd).to(torch.float32)
    k = k.reshape(B, S, nh, hd).to(torch.float32)
    v = v.reshape(B, S, nh, hd).to(torch.float32)
    g = activation(lerp(p["mu_g"]) @ p["wg"], "silu")
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

    def heads(r, k, v, logw, u, S0=None):
        """``wkv6`` over [b, S, nh, hd] heads -> (y [b, S, D], the final
        state [b, nh, hd, hd])."""
        b = r.shape[0]

        def rows(t):                # [b, S, nh, hd] -> [b nh, S, hd]
            return t.transpose(1, 2).reshape(b * nh, S, hd).contiguous()
        u = u.to(torch.float32).expand(b, nh, hd).reshape(b * nh, hd)
        state = None if S0 is None else \
            S0.to(torch.float32).reshape(b * nh, hd, hd).contiguous()
        y, S_fin = wkv6(rows(r), rows(k), rows(v), rows(logw),
                        u.contiguous(), state)
        return (y.reshape(b, nh, S, hd).transpose(1, 2).reshape(b, S, D),
                S_fin.reshape(b, nh, hd, hd))
    if is_dtensor(r):
        # on a mesh, on each device's local batch shard: ``batch_layout``
        # holds the inputs to it (any other layout raises), u replicated
        args = [r, k, v, logw] + ([] if S0 is None else
                                  [as_dtensor(S0, r.device_mesh)])
        pl = batch_placements(*args, what="wkv6")
        u = as_dtensor(p["u"], r.device_mesh)
        if not all(q.is_replicate() for q in u.placements):
            raise ValueError(f"wkv6: u must be replicated, got "
                             f"{tuple(u.placements)}")
        args.insert(4, u)
        y, S_fin = run_local(heads, args, (pl, pl))
    else:
        y, S_fin = heads(r, k, v, logw, p["u"], S0)
    # held after the head merge, so backward brings the gradient to the
    # head split batch-sharded (a no-op without a mesh)
    y, = batch_layout(y, decode=S == 1)
    return _time_mix_out(p, y, g, xn.dtype), (S_fin, shift_out)


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
