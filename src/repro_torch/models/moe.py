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

On a device mesh (a DTensor x) the dispatch is expert-parallel
(:func:`_moe_on_mesh`): each device routes only its own batch shard, the
tokens replicated over the axes the experts are split on, and runs the
experts it holds on its own shard's kept assignments; the weighted
contributions leave as partial sums over those axes, reduced where the
residual stream is held. No device holds the whole batch. The capacity
and the dropped assignments are the unsharded dispatch's: an
assignment's position within its expert is the count of that expert's
assignments on lower batch shards (an exclusive prefix over the
all-gathered ``[E]`` counts) plus its stable position in its own shard,
against ``C`` from the global token count; and the aux loss's means are
over the global batch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (BATCH_AXES, P, as_dtensor,
                                              is_dtensor, is_shard, placements,
                                              run_local)
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


def _probs(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [T, D] -> (top_w [T, K] fp32, renormalised; top_e [T, K]; the
    router's fp32 softmax [T, E])."""
    logits = xf.to(torch.float32) @ router.to(torch.float32)      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e, probs


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [T, D] -> (top_w [T, K] fp32, renormalised; top_e [T, K];
    aux loss, a scalar)."""
    e = cfg.moe
    T = xf.shape[0]
    top_w, top_e, probs = _probs(cfg, router, xf)
    one_hot = F.one_hot(top_e, e.n_routed).to(torch.float32)      # [T, K, E]
    f = one_hot.sum((0, 1)) / (T * e.top_k)
    pbar = probs.mean(0)
    aux = e.aux_loss_weight * e.n_routed * torch.sum(f * pbar)
    return top_w, top_e, aux


def _positions(top_e: torch.Tensor, E: int):
    """The stable sort of the (token, k) assignments by expert: (order,
    s_e, each assignment's position within its expert)."""
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    s_e = flat_e[order]
    # each expert's first index in the sorted order (the reference's
    # cumsum of bincount; this form has a static shape under FakeTensorMode)
    starts = torch.searchsorted(s_e, torch.arange(E, device=s_e.device))
    pos = torch.arange(s_e.shape[0], device=s_e.device) - starts[s_e]
    return order, s_e, pos


def _routed(xf, top_w, top_e, E: int, C: int, cap: int, wi0, wi1, wo,
            offsets=None, e0=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on plain tensors: xf [T, D], top_w / top_e
    [T, K] -> (y [T, D] in xf's dtype, the weighted sum of each token's
    kept contributions from the experts ``e0 .. e0 + E_l - 1`` that
    ``wi0``, ``wi1`` [E_l, D, F] and ``wo`` [E_l, F, D] hold; the kept
    mask [T, K]). An assignment is kept where its expert is one of those
    and its position within its expert plus ``offsets`` [E] (None: 0; the
    expert's assignments on lower batch shards) is below ``C``; a kept
    one takes the row of its position among its expert's ``cap`` rows, so
    ``cap`` must hold this call's kept assignments of any one expert.
    Row ``E_l * cap`` of the buffer takes the others and is discarded."""
    T, D = xf.shape
    K = top_e.shape[1]
    E_l = wi0.shape[0]
    order, s_e, pos = _positions(top_e, E)
    s_tok = torch.arange(T, device=xf.device).repeat_interleave(K)[order]
    s_w = top_w.reshape(-1)[order]
    gpos = pos if offsets is None else pos + offsets[s_e]
    ok = (gpos < C) & (s_e >= e0) & (s_e < e0 + E_l)
    slot = torch.where(ok, (s_e - e0) * cap + pos,
                       torch.full_like(pos, E_l * cap))
    buf = torch.zeros((E_l * cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[slot] = xf[s_tok]
    h = buf[:E_l * cap].reshape(E_l, cap, D)
    gate = F.silu(torch.bmm(h, wi0))
    up = torch.bmm(h, wi1)
    out = torch.bmm(gate * up, wo)                                 # [E_l, cap, D]

    y_sorted = out.reshape(E_l * cap, D)[torch.clamp(slot, max=E_l * cap - 1)]
    contrib = (y_sorted * (s_w * ok)[:, None]).to(xf.dtype)
    by_k = torch.empty_like(contrib)
    by_k[order] = contrib               # back to (token, k) order
    by_k = by_k.reshape(T, K, D)
    kept = torch.empty_like(ok)
    kept[order] = ok
    y = torch.zeros((T, D), dtype=xf.dtype, device=xf.device)
    for k in range(K):
        y = y + by_k[:, k]
    return y, kept.reshape(T, K)


def _shared(p: dict, xf: torch.Tensor) -> torch.Tensor:
    """The shared expert: a gated MLP through ``linear``."""
    sp = p["shared"]
    return linear(linear(xf, sp["wi0"], act="silu")
                  * linear(xf, sp["wi1"]), sp["wo"])


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D] in x's dtype, aux loss scalar). A
    DTensor x takes the expert-parallel dispatch (:func:`_moe_on_mesh`)."""
    if is_dtensor(x):
        return _moe_on_mesh(cfg, p, x)
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    top_w, top_e, aux = route(cfg, p["router"], xf)
    C = capacity(cfg, T)
    y, _ = _routed(xf, top_w, top_e, e.n_routed, C, C, p["wi0"], p["wi1"],
                   p["wo"])
    if e.n_shared:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D), aux


def _mesh_route(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The routing half of :func:`_moe_on_mesh` on each device's batch
    shard: (xf [T, D] laid out as the residual stream, top_w, top_e,
    each shard's exclusive prefix of the experts' counts [n, E] laid out as
    xf, the aux loss, a replicated scalar)."""
    from torch.distributed.tensor import Partial, Replicate
    e = cfg.moe
    E, K = e.n_routed, e.top_k
    B, S, D = x.shape
    T = B * S
    mesh = x.device_mesh
    # the residual stream's layout: the batch over (pod, data), the tokens
    # replicated over every other axis (the experts' among them)
    tokens = placements(P(BATCH_AXES, None, None), mesh, x.shape)
    if list(x.placements) != tokens:
        x = x.redistribute(mesh, tokens)
    xf = x.reshape(T, D)
    pl = list(xf.placements)
    router = as_dtensor(p["router"], mesh)
    rep = [Replicate()] * mesh.ndim
    if list(router.placements) != rep:
        router = router.redistribute(mesh, rep)

    def local(xf, router):
        top_w, top_e, probs = _probs(cfg, router, xf)
        counts = torch.zeros(E, dtype=torch.int64, device=xf.device)
        counts.scatter_add_(0, top_e.reshape(-1), torch.ones_like(
            top_e.reshape(-1), dtype=torch.int64))
        return top_w, top_e, counts[None], probs.sum(0)
    psum_pl = [Partial() if is_shard(q) else Replicate() for q in pl]
    top_w, top_e, counts, psum = run_local(local, [xf, router],
                                           (pl, pl, pl, psum_pl))
    # every shard's counts (the [E] all-gather), then each shard's
    # exclusive prefix: its own row is a local slice, no collective
    counts = counts.redistribute(mesh, rep)
    offsets = (counts.cumsum(0) - counts).redistribute(mesh, pl)
    f = counts.sum(0).to(torch.float32) / (T * K)
    pbar = psum.redistribute(mesh, rep) / T
    aux = e.aux_loss_weight * E * torch.sum(f * pbar)
    return xf, top_w, top_e, offsets, aux


def _moe_on_mesh(cfg: ModelConfig, p: dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` expert-parallel, on a DTensor x (module
    docstring). The routed stacks are split over experts (``Shard(0)``) on
    the axes they name ("model" at the production widths) and whole on the
    others (an F split, left by no ``gather_fsdp``, is gathered here); the
    tokens are replicated on the experts' axes. Each device runs
    :func:`_routed` on its batch shard with the experts it holds, at ``cap
    = min(C, T_l K)`` rows an expert (its shard's kept assignments of one
    expert never exceed either), and its contributions leave as partial
    sums over the experts' axes. Collectives: the ``[E]`` counts'
    all-gather and the aux loss's ``[E]`` all-reduce; the contributions'
    reduction, O(local tokens x D), falls where the caller holds y."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    e = cfg.moe
    E = e.n_routed
    B, S, D = x.shape
    mesh = x.device_mesh
    xf, top_w, top_e, offsets, aux = _mesh_route(cfg, p, x)
    pl = list(xf.placements)
    ws = [as_dtensor(p[k], mesh) for k in ("wi0", "wi1", "wo")]
    w_pl = [Shard(0) if is_shard(q, 0) else Replicate()
            for q in ws[0].placements]
    ws = [w if list(w.placements) == w_pl else w.redistribute(mesh, w_pl)
          for w in ws]
    if any(is_shard(a) and is_shard(b) for a, b in zip(pl, w_pl)):
        raise ValueError(f"moe: the tokens {tuple(pl)} are split on an "
                         f"axis the experts {tuple(w_pl)} are split on")
    eids = as_dtensor(torch.arange(E, device=x.device),
                      mesh).redistribute(mesh, w_pl)
    C = capacity(cfg, B * S)
    out_pl = [Partial() if is_shard(q) else a for q, a in zip(w_pl, pl)]

    def local(xf, top_w, top_e, offsets, eids, wi0, wi1, wo):
        cap = min(C, top_e.numel())
        return _routed(xf, top_w, top_e, E, C, cap, wi0, wi1, wo,
                       offsets[0], eids[0])[0]
    y = run_local(local, [xf, top_w, top_e, offsets, eids] + ws, out_pl)
    if e.n_shared:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D), aux

