"""Shared layer primitives: norms, RoPE / M-RoPE, linear, MLPs.

:func:`linear` is the precision routing point of the swap path: a weight
that arrives as a :class:`~repro_torch.kernels.qtensor.QuantizedTensor`
(the quantized store's lazy mode) streams through the fused dequant-matmul
kernel, so fp for that weight never exists in device memory. A plain
tensor (the mmap store, eager quant's dequantized leaves, the in-memory
model) streams through the full-precision kernel ``swap_linear``. On the
CPU both take their plain versions. On a device mesh (DTensor operands)
``swap_linear`` runs on each device's local shards (:func:`linear`).

The arithmetic mirrors the JAX package op for op (fp32 norms and RoPE,
the activations' formulas), so float32 configs agree across the two
packages up to accumulation order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (as_dtensor, is_dtensor,
                                              is_shard, run_local)
from repro_torch.kernels.qtensor import QuantizedTensor
from repro_torch.kernels.swap_linear import swap_linear
from repro_torch.kernels.swap_linear_q import swap_linear_q
from repro_torch.models.params import ParamDef


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w) if plus_one else w
    return (x * scale).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


# ------------------------------------------------------------------ rotary
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """positions [B, S] (RoPE) or [B, S, 3] (M-RoPE) -> angles
    [B, S, head_dim / 2]. With ``mrope_sections`` (Qwen2-VL) the frequency
    slots split into (t, h, w) sections, each driven by its own position
    stream: slot i reads stream ``repeat(arange(3), sections)[i]``."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=positions.device), exps)
    if mrope_sections is None:
        return positions.to(torch.float32)[..., None] * inv_freq
    if sum(mrope_sections) != half:
        raise ValueError(f"mrope_sections {tuple(mrope_sections)} do not "
                         f"sum to head_dim / 2 = {half}")
    section_id = torch.tensor([i for i, n in enumerate(mrope_sections)
                               for _ in range(n)], device=positions.device)
    return positions.to(torch.float32)[..., section_id] * inv_freq


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, head_dim]; angles [B, S, head_dim / 2] (neox halves)."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# ------------------------------------------------------------------ linear
def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           act: str = "none") -> torch.Tensor:
    """y = act(x @ w + b), routed by weight representation: a
    QuantizedTensor goes through ``swap_linear_q``, a tensor through
    ``swap_linear`` (fp32 accumulator, bias and activation in fp32, the
    result in x's dtype). The leading axes of x are flattened for the
    kernel and restored after. A DTensor operand takes
    :func:`_linear_on_shards`; a quantized weight (serving) runs on plain
    tensors only, and a DTensor x with one raises ``ValueError``."""
    if isinstance(w, QuantizedTensor):
        if is_dtensor(x) or is_dtensor(b):
            raise ValueError("linear: a QuantizedTensor weight takes plain "
                             "tensors; the mesh path has no quantized "
                             "linear")
        return _linear_2d(x, w, b, act)
    if is_dtensor(x) or is_dtensor(w):
        return _linear_on_shards(x, w, b, act)
    return _linear_2d(x, w, b, act)


def _linear_2d(x: torch.Tensor, w, b: Optional[torch.Tensor],
               act: str) -> torch.Tensor:
    """The kernel call on plain tensors, x's leading axes flattened."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    if isinstance(w, QuantizedTensor):
        y = swap_linear_q(x2d, w.q, w.scales, b, bits=w.bits, act=act)
    else:
        y = swap_linear(x2d, w, b, act=act)
    return y.reshape(*lead, y.shape[-1])


def _linear_on_shards(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], act: str) -> torch.Tensor:
    """:func:`linear` on a device mesh: the kernel on each device's local
    shards (``run_local``), the layout chosen on each mesh axis. Where x's
    rows are split, the weight is gathered whole there (data parallelism:
    a weight is far smaller than the activations it would otherwise move)
    and the output's rows are split as x's. Elsewhere the weight sets it:
    a column-parallel weight (``Shard(1)``, N split) takes x whole and
    gives ``Shard(-1)``; a row-parallel one (``Shard(0)``, K split) takes
    x split on its last dim and gives ``Partial`` sums, so a bias or an
    activation, which a partial sum must not see, raises ``ValueError``; a
    replicated one takes x whole (a split K gathered first). Operands are
    redistributed to that layout where they differ (a plain one is taken
    as replicated); the output keeps x's leading axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    last = x.ndim - 1
    x_pl, w_pl, out_pl, b_pl = [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if is_shard(px) and px.dim < last:
            pw, px_to, out = Replicate(), px, px
        elif is_shard(pw, 1):
            px_to, out = Replicate(), Shard(last)
        elif is_shard(pw, 0):
            if b is not None or act != "none":
                raise ValueError(
                    f"linear: a K-sharded weight {tuple(w.placements)} "
                    f"gives partial sums; a fused bias or activation "
                    f"({'bias' if b is not None else act}) would act on "
                    f"each of them")
            px_to, out = Shard(last), Partial()
        else:
            pw, px_to, out = Replicate(), Replicate(), Replicate()
        x_pl.append(px_to)
        w_pl.append(pw)
        out_pl.append(out)
        b_pl.append(Shard(0) if is_shard(pw, 1) else Replicate())
    if list(x.placements) != x_pl:
        x = x.redistribute(mesh, x_pl)
    if list(w.placements) != w_pl:
        w = w.redistribute(mesh, w_pl)
    args = [x, w]
    if b is not None:
        b = as_dtensor(b, mesh)
        args.append(b if list(b.placements) == b_pl
                    else b.redistribute(mesh, b_pl))

    def local(x, w, b=None):
        return _linear_2d(x, w, b, act)
    return run_local(local, args, out_pl)


# ------------------------------------------------------------------ MLP
def mlp_defs(cfg: ModelConfig, d_in: int, d_hidden: int) -> dict:
    if cfg.act in ("swiglu", "gelu_glu"):
        return {"wi0": ParamDef((d_in, d_hidden), ("residual", "tp")),
                "wi1": ParamDef((d_in, d_hidden), ("residual", "tp")),
                "wo": ParamDef((d_hidden, d_in), ("tp", "residual"))}
    return {"wi": ParamDef((d_in, d_hidden), ("residual", "tp")),
            "wo": ParamDef((d_hidden, d_in), ("tp", "residual"))}


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("swiglu", "gelu_glu"):
        gate = linear(x, p["wi0"],
                      act="silu" if cfg.act == "swiglu" else "gelu")
        return linear(gate * linear(x, p["wi1"]), p["wo"])
    h = F.gelu(linear(x, p["wi"]), approximate="tanh")
    return linear(h, p["wo"])


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
