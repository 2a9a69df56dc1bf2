"""Mixture-of-Experts: top-k router + capacity-based sort/gather dispatch.

The JAX package's ``models/moe.py`` op for op: an fp32 softmax router,
``top_k`` with renormalised weights, the Switch load-balance aux loss,
then a per-expert capacity ``C`` and a stable sort of the (token, k)
assignments by expert. An assignment past its expert's C slots is
dropped (its slot is the discard row ``E * C``). The experts run on an
[E, C, D] buffer, so no dense [T, E, C] dispatch tensor is ever built.

The three routed-expert products are batched matmuls (``torch.bmm``), as
the reference leaves its einsums to XLA outside any kernel. The shared
expert's 2-D weights go through :func:`~repro_torch.models.layers.linear`,
so they stream through ``swap_linear`` (``swap_linear_q`` when they stay
quantized). The 3-D routed stacks are dequantized at use (the quantized
store never fuses them).

Combining the experts' outputs is deterministic: each token's k
contributions are put back in assignment order (a permutation, no
collisions) and added in k order, never with ``index_add_``, whose CUDA
version sums with atomics in an order that changes between runs.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (BATCH_AXES, MODEL_AXIS, P,
                                              full_tensor, maybe_constrain,
                                              on_mesh)
from repro_torch.models.layers import linear
from repro_torch.models.params import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    """router [D, E]; routed stacks wi0, wi1 [E, D, F] and wo [E, F, D];
    the shared expert's 2-D wi0, wi1 [D, Fs] and wo [Fs, D]. A stack's
    ``fan_in`` is its first axis, E, as in the reference's init."""
    e = cfg.moe
    D = cfg.d_model
    d = {"router": ParamDef((D, e.n_routed), ("residual", None),
                            init="small"),
         "wi0": ParamDef((e.n_routed, D, e.d_expert),
                         ("experts", None, "residual")),
         "wi1": ParamDef((e.n_routed, D, e.d_expert),
                         ("experts", None, "residual")),
         "wo": ParamDef((e.n_routed, e.d_expert, D),
                        ("experts", "residual", None))}
    if e.n_shared:
        ds = e.d_shared or e.d_expert * e.n_shared
        d["shared"] = {"wi0": ParamDef((D, ds), ("residual", "tp")),
                       "wi1": ParamDef((D, ds), ("residual", "tp")),
                       "wo": ParamDef((ds, D), ("tp", "residual"))}
    return d


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ``ceil(T * K / E) * capacity_factor``, rounded
    down to a multiple of 8 and at least 8 (the reference's integers)."""
    e = cfg.moe
    per = -(-n_tokens * e.top_k // e.n_routed)
    return max(8, int(per * e.capacity_factor) // 8 * 8)


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [T, D] -> (top_w [T, K] fp32, renormalised; top_e [T, K];
    aux loss, a scalar)."""
    e = cfg.moe
    T = xf.shape[0]
    logits = xf.to(torch.float32) @ router.to(torch.float32)      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, e.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    one_hot = F.one_hot(top_e, e.n_routed).to(torch.float32)      # [T, K, E]
    f = one_hot.sum((0, 1)) / (T * e.top_k)
    pbar = probs.mean(0)
    aux = e.aux_loss_weight * e.n_routed * torch.sum(f * pbar)
    return top_w, top_e, aux


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux loss scalar)."""
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = e.n_routed, e.top_k
    # for a DTensor x the routing and the dispatch's sort and index ops run
    # on every device's copy of the whole batch (DTensor shards none of
    # them), unlike the reference's expert-parallel dispatch; the experts
    # run expert-parallel (no-ops for a plain x)
    x_in, x = x, full_tensor(x)
    xf = x.reshape(T, D)
    dev = x.device
    top_w, top_e, aux = route(cfg, full_tensor(p["router"]), xf)

    C = capacity(cfg, T)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)    # [T*K]
    flat_e = top_e.reshape(-1)
    flat_w = top_w.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    s_tok, s_e, s_w = flat_tok[order], flat_e[order], flat_w[order]
    # each expert's first index in the sorted order (the reference's
    # cumsum of bincount; this form has a static shape under FakeTensorMode)
    starts = torch.searchsorted(s_e, torch.arange(E, device=dev))
    pos = torch.arange(T * K, device=dev) - starts[s_e]
    ok = pos < C
    slot = torch.where(ok, s_e * C + pos, torch.full_like(pos, E * C))

    # row E * C takes the dropped assignments and is discarded
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = xf[s_tok]
    h = on_mesh(buf[:E * C].reshape(E, C, D), x_in,
                P(MODEL_AXIS, None, None))
    gate = F.silu(torch.bmm(h, p["wi0"]))
    up = torch.bmm(h, p["wi1"])
    out = torch.bmm(gate * up, p["wo"])                            # [E, C, D]
    out = full_tensor(maybe_constrain(out, P(MODEL_AXIS, None, None)))

    y_sorted = out.reshape(E * C, D)[torch.clamp(slot, max=E * C - 1)]
    contrib = (y_sorted * (s_w * ok)[:, None]).to(x.dtype)
    by_k = torch.empty_like(contrib)
    by_k[order] = contrib               # back to (token, k) order
    by_k = by_k.reshape(T, K, D)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev)
    for k in range(K):
        y = y + by_k[:, k]

    # back on the mesh with the tokens batch-sharded; every tensor that
    # leaves the whole-batch copy does so here, so no gradient comes back
    # into it as a DTensor
    tokens = P(BATCH_AXES, None)
    y = on_mesh(y, x_in, tokens)
    if e.n_shared:
        sp = p["shared"]
        xs = on_mesh(xf, x_in, tokens)
        y = y + linear(linear(xs, sp["wi0"], act="silu")
                       * linear(xs, sp["wi1"]), sp["wo"])
    return y.reshape(B, S, D), on_mesh(aux, x_in, P())
