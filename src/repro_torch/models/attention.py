"""Attention: GQA with RoPE or M-RoPE and causal / sliding-window /
softcap masks (none for an encoder), for prefill and for single-token
decode on a contiguous cache or through the paged KV cache
(:func:`gqa_apply_paged`); and deepseek-v2's Multi-head
Latent Attention (:func:`mla_apply`), whose decode cache holds one
compressed latent and one RoPE key per token instead of K and V per head.

Prefill (Sq == Skv, no cache) runs the ``flash_attention`` kernel
(``kernels/flash_attention.py``; its plain version on the CPU). Decode on
the contiguous cache runs :func:`online_attention`, as the JAX package
computes that step outside any kernel (its ``models/attention.py``): the
TPU kernel is prefill-only, so this is no plain version of it on the card.

:func:`online_attention` scans KV in chunks with running (m, l, acc)
statistics, so the [Sq, Skv] score matrix never materializes at full
sequence length. Masking is positional, as in the JAX package: kv position
j attends iff ``j <= q_pos`` (causal), ``q_pos - j < window``,
``q_pos // block_local == j // block_local`` (llama4's iRoPE local
layers) and ``j < kv_valid_len``; masked scores are ``NEG_INF`` (finite,
so a fully masked chunk cannot produce NaN) and ``l`` is clamped at
1e-30. The prefill kernel keeps these semantics (``block_local`` is its
``chunk``).

On a device mesh (DTensor q, k, v) the prefill kernel runs on each
device's local batch shard (:func:`_prefill_attention`). Two decode forms
of the JAX package's dry run are here too: with
:data:`SHARDED_DECODE_AXIS` set and a mesh installed, a decode step on a
sequence-sharded cache writes and attends to each device's cache rows
locally and combines the partial softmax statistics across the shards
(:func:`_flash_decode_sharded`); and a ``swa`` layer whose cache is no
longer than its window treats the cache as a ring buffer
(:func:`_windowed_decode`, the cache ``transformer.WINDOWED_KV_CACHE``
allocates).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (as_dtensor, batch_layout,
                                              batch_placements, get_mesh,
                                              is_dtensor, is_shard,
                                              run_local)
from repro_torch.kernels.flash_attention import (LARGE_WINDOW, NEG_INF,
                                                  flash_attention)
from repro_torch.models.layers import (apply_rope, linear, rms_norm,
                                       rope_angles, softcap)
from repro_torch.models.params import ParamDef

# Flash-decoding over the sequence-sharded KV cache (the JAX package's
# switch of the same name): a mesh axis name or tuple of them; with a mesh
# installed, a GQA decode step on a DTensor cache writes and attends to the
# cache rows of each device locally and combines the partial (m, l, acc)
# by max and sum over these axes (:func:`_flash_decode_sharded`) instead
# of letting DTensor reduce the scores. Set by the dry run's
# ``--flash-decode``; None keeps the plain decode.
SHARDED_DECODE_AXIS = None


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor,
                     kv_valid_len: Optional[torch.Tensor], *, causal: bool,
                     window: Optional[int], scale: float,
                     logit_cap: Optional[float], chunk: int = 1024,
                     block_local: Optional[int] = None) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Skv,KV,hd], q_pos [B,Sq] absolute positions
    -> [B,Sq,H,vd] fp32. ``block_local`` (None: none) confines a query to
    the keys of its own ``block_local``-token block."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd).to(torch.float32)
    window = LARGE_WINDOW if window is None else window
    chunk = min(chunk, Skv)
    if is_dtensor(k):
        # DTensor slices a sequence-sharded cache only by gathering it
        # whole; one chunk keeps the scores sharded as the cache is (the
        # flash-decoding split: the max and sums reduce across shards)
        chunk = Skv
    dev = q.device

    qp = q_pos[:, :, None, None, None]                       # [B,Sq,1,1,1]
    valid_len = (kv_valid_len[:, None, None, None, None]
                 if kv_valid_len is not None else None)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, vd), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, chunk):
        kc = k[:, c0:c0 + chunk].to(torch.float32)
        vc = v[:, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bqkgh,bckh->bqkgc", q, kc) * scale
        s = softcap(s, logit_cap)
        pc = torch.arange(c0, c0 + kc.shape[1], device=dev)[None, None, None,
                                                             None, :]
        mask = pc < Skv
        if causal:
            mask = mask & (pc <= qp) & ((qp - pc) < window)
        if block_local is not None:
            mask = mask & (torch.div(qp, block_local, rounding_mode="floor")
                           == torch.div(pc, block_local,
                                        rounding_mode="floor"))
        if valid_len is not None:
            mask = mask & (pc < valid_len)
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, vd)


def write_rows(buf: torch.Tensor, pos: torch.Tensor,
               rows: torch.Tensor) -> None:
    """``buf[b, pos[b]] = rows[b]`` in place (buf [B, L, ...], pos [B]).
    For a DTensor ``buf`` (whose in-place ``index_put_`` cannot keep a
    sequence-sharded cache's placement) the same rows are written by a
    ``where`` over the sequence and a ``copy_``."""
    rows = rows.to(buf.dtype)
    if not is_dtensor(buf):
        buf[torch.arange(buf.shape[0], device=buf.device), pos] = rows
        return
    hit = (torch.arange(buf.shape[1], device=buf.device)[None, :]
           == pos[:, None])
    hit = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
    buf.copy_(torch.where(hit, rows[:, None], buf))


def _prefill_attention(q, k, v, q_pos, **kw) -> torch.Tensor:
    """``flash_attention``; on DTensors, on each device's local batch
    shard. q, k and v must share a layout that shards the batch and
    nothing else (``batch_layout`` holds them to it; any other raises);
    q_pos, an index, is laid out as q (a plain one taken as replicated)."""
    if not is_dtensor(q):
        return flash_attention(q, k, v, q_pos, **kw)
    pl = batch_placements(q, k, v, what="flash_attention")
    mesh = q.device_mesh
    q_pos = as_dtensor(q_pos, mesh)
    if list(q_pos.placements) != pl:
        q_pos = q_pos.redistribute(mesh, pl)

    def local(q, k, v, q_pos):
        return flash_attention(q, k, v, q_pos, **kw)
    return run_local(local, [q, k, v, q_pos], pl)


def _windowed_decode(q: torch.Tensor, cache: dict, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: torch.Tensor, *,
                     scale: float, logit_cap: Optional[float]
                     ) -> torch.Tensor:
    """Single-token decode against a ring-buffer cache of W slots, the JAX
    package's ``_windowed_decode``: the new K / V go to slot ``pos % W``
    (in place), and slot i holds the absolute position
    ``i + floor((pos - i) / W) * W``, the newest one congruent to i (a
    negative one is not yet written and is masked). q [B, 1, H, hd] ->
    [B, 1, H, hd] fp32."""
    B, _, H, hd = q.shape
    W, KV = cache["k"].shape[1], cache["k"].shape[2]
    G = H // KV
    slot = torch.remainder(pos, W)
    write_rows(cache["k"], slot, k_new[:, 0])
    write_rows(cache["v"], slot, v_new[:, 0])
    slots = torch.arange(W, device=q.device)
    kv_pos = slots[None, :] + torch.div(pos[:, None] - slots[None, :], W,
                                        rounding_mode="floor") * W
    qf = q.reshape(B, KV, G, hd).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qf,
                     cache["k"].to(torch.float32)) * scale
    s = softcap(s, logit_cap)
    s = torch.where((kv_pos >= 0)[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, cache["v"].to(torch.float32))
    return out.reshape(B, 1, H, hd)


def _flash_decode_sharded(q, cache_k, cache_v, k_new, v_new, decode_pos, *,
                          axis, scale: float, window: int,
                          logit_cap: Optional[float],
                          block_local: Optional[int] = None
                          ) -> torch.Tensor:
    """Flash-decoding over a cache [B, S, KV, hd] whose sequence is sharded
    over ``axis`` (the JAX package's ``_flash_decode_sharded``). On each
    device, on its local rows (``run_local``):

    1. k / v_new [B, 1, KV, hd] go into the local cache shard, in place,
       only where ``decode_pos`` lands in it: no resharded write;
    2. partial (m, l, acc) over the local rows, with the causal, window
       and block-local masks at the rows' absolute positions;
    3. the partials combined by an all-reduce max and sums over the
       sequence axes: bytes a layer O(B H hd), not O(B S KV hd).

    The cache's sequence must be sharded over exactly ``axis`` (the mesh's
    axes of it), else ``ValueError``. q, k / v_new and the positions are
    laid out as the cache's batch. Returns [B, 1, H, hd] in q's dtype,
    replicated over the sequence axes."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in ((axis,) if isinstance(axis, str) else axis)
                 if a in names)
    cpl = list(cache_k.placements)
    if (tuple(n for n, p in zip(names, cpl) if is_shard(p, 1)) != axes
            or not all(is_shard(p, 0) or is_shard(p, 1) or p.is_replicate()
                       for p in cpl) or list(cache_v.placements) != cpl):
        raise ValueError(f"flash-decode over {axes}: the cache's placements "
                         f"{tuple(cpl)} do not shard its sequence over them")
    pl = [Shard(0) if is_shard(p, 0) else Replicate() for p in cpl]
    args = []
    for t in (q, k_new, v_new, decode_pos):
        t = as_dtensor(t, mesh)
        args.append(t if list(t.placements) == pl
                    else t.redistribute(mesh, pl))
    q, k_new, v_new, decode_pos = args
    dims = [names.index(a) for a in axes]
    B, _, H, hd = q.shape
    KV = cache_k.shape[2]
    G = H // KV

    def local(qv, ck, cv, kn, vn, pos):
        Bl, S_loc = qv.shape[0], ck.shape[1]
        idx = 0
        for d in dims:                  # row-major over the sequence axes
            idx = idx * mesh.size(d) + mesh.get_local_rank(d)
        rows = idx * S_loc + torch.arange(S_loc, device=qv.device)
        hit = (rows[None, :] == pos[:, None])[:, :, None, None]
        ck.copy_(torch.where(hit, kn.to(ck.dtype), ck))
        cv.copy_(torch.where(hit, vn.to(cv.dtype), cv))
        qf = qv.reshape(Bl, KV, G, hd).to(torch.float32)
        s = torch.einsum("bkgh,bskh->bkgs", qf,
                         ck.to(torch.float32)) * scale
        s = softcap(s, logit_cap)
        qp = pos[:, None, None, None]
        kvp = rows[None, None, None, :]
        mask = (kvp <= qp) & ((qp - kvp) < window)
        if block_local is not None:
            mask = mask & (torch.div(qp, block_local, rounding_mode="floor")
                           == torch.div(kvp, block_local,
                                        rounding_mode="floor"))
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bkgs,bskh->bkgh", p, cv.to(torch.float32))
        m_g = m
        for d in dims:
            m_g = funcol.all_reduce(m_g, "max", (mesh, d))
        corr = torch.exp(m - m_g)
        l_g, acc_g = l * corr, acc * corr[..., None]
        for d in dims:
            l_g = funcol.all_reduce(l_g, "sum", (mesh, d))
            acc_g = funcol.all_reduce(acc_g, "sum", (mesh, d))
        out = acc_g / torch.clamp(l_g[..., None], min=1e-30)
        return out.reshape(Bl, 1, H, hd).to(qv.dtype)
    return run_local(local, [q, cache_k, cache_v, k_new, v_new, decode_pos],
                     pl)


# ------------------------------------------------------------------ GQA layer
def gqa_defs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    d = {"wq": ParamDef((D, H * hd), ("residual", "tp")),
         "wk": ParamDef((D, KV * hd), ("residual", "tp")),
         "wv": ParamDef((D, KV * hd), ("residual", "tp")),
         "wo": ParamDef((H * hd, D), ("tp", "residual"))}
    if cfg.attn_bias:
        d["bq"] = ParamDef((H * hd,), ("tp",), init="zeros")
        d["bk"] = ParamDef((KV * hd,), ("tp",), init="zeros")
        d["bv"] = ParamDef((KV * hd,), ("tp",), init="zeros")
    return d


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.resolved_head_dim ** -0.5


def _rope(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on q and k (none for ``rope_type="none"``); M-RoPE reads its
    three position streams from ``positions`` [B, S, 3]."""
    if cfg.rope_type == "none":
        return q, k
    sections = cfg.mrope_sections if cfg.rope_type == "mrope" else None
    ang = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                      sections)
    return apply_rope(q, ang), apply_rope(k, ang)


def gqa_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, is_local: bool,
              cache: Optional[dict], decode_pos: Optional[torch.Tensor],
              chunk: int = 1024) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,D]. Prefill: ``cache=None`` in, the new cache (k, v) out;
    attention runs the ``flash_attention`` kernel. Decode:
    ``cache={'k','v'}`` of [B,Smax,KV,hd] and ``decode_pos`` [B], the write
    index; attention runs :func:`online_attention` over the cache (no
    kernel: the reference computes that step in XLA), or on an ``swa``
    cache no longer than the window :func:`_windowed_decode`, or with
    :data:`SHARDED_DECODE_AXIS` on a mesh :func:`_flash_decode_sharded`,
    as the JAX package branches. The decode cache is
    updated IN PLACE (one row per sequence) instead of copied, and
    returned. With M-RoPE (qwen2-vl) ``positions`` is [B, S, 3] and both
    paths mask on its temporal stream ``positions[..., 0]`` against the
    key's index, as the JAX package does: a caller whose temporal stream
    is not the token index (Qwen2-VL's published rule gives an image one
    temporal position) gets that package's mask, not the index mask."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = batch_layout(linear(x, p["wq"], p.get("bq")),
                          linear(x, p["wk"], p.get("bk")),
                          linear(x, p["wv"], p.get("bv")),
                          decode=decode_pos is not None)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q, k = _rope(cfg, q, k, positions)

    window = None
    if cfg.sliding_window is not None:
        if cfg.layer_pattern == "swa":
            window = cfg.sliding_window
        else:       # alternating local/global: is_local is a python bool
            window = cfg.sliding_window if is_local else LARGE_WINDOW
    block_local = None
    if cfg.attn_chunk is not None and cfg.layer_pattern == "chunked":
        # llama4 iRoPE: 3/4 layers attend within attn_chunk-sized blocks
        block_local = cfg.attn_chunk if is_local else None
    # M-RoPE masks on the temporal stream, as the JAX package does
    q_pos = positions[..., 0] if cfg.rope_type == "mrope" else positions
    decode = cache is not None and decode_pos is not None
    if (decode and cfg.layer_pattern == "swa"
            and cfg.sliding_window is not None
            and cache["k"].shape[1] <= cfg.sliding_window):
        # a cache no longer than the window is a ring buffer (the JAX
        # package's branch, taken where it takes it)
        out = _windowed_decode(q, cache, k, v, decode_pos,
                               scale=_attn_scale(cfg),
                               logit_cap=cfg.attn_logit_softcap)
    elif (decode and SHARDED_DECODE_AXIS is not None
          and get_mesh() is not None and is_dtensor(cache["k"])):
        out = _flash_decode_sharded(
            q, cache["k"], cache["v"], k, v, decode_pos,
            axis=SHARDED_DECODE_AXIS, scale=_attn_scale(cfg),
            window=LARGE_WINDOW if window is None else window,
            logit_cap=cfg.attn_logit_softcap, block_local=block_local)
    elif decode:
        write_rows(cache["k"], decode_pos, k[:, 0])
        write_rows(cache["v"], decode_pos, v[:, 0])
        out = online_attention(q, cache["k"], cache["v"], q_pos,
                               decode_pos + 1, causal=not cfg.is_encoder,
                               window=window, scale=_attn_scale(cfg),
                               logit_cap=cfg.attn_logit_softcap, chunk=chunk,
                               block_local=block_local)
    else:
        out = _prefill_attention(q, k, v, q_pos, scale=_attn_scale(cfg),
                                 causal=not cfg.is_encoder, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 chunk=block_local)
    # held after the head merge, so backward brings the gradient to the
    # head split in the inputs' layout
    out, = batch_layout(out.reshape(B, S, H * hd),
                        decode=decode_pos is not None)
    out = linear(out.to(x.dtype), p["wo"])
    new_cache = cache if cache is not None else {"k": k, "v": v}
    return out, new_cache


def gqa_apply_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor, is_local: bool,
                    paged) -> torch.Tensor:
    """Single-token batched decode through the paged KV cache
    (``serving/paged_kv.py``): q/k/v projections and RoPE exactly as
    :func:`gqa_apply`, then the new K/V are appended to each sequence's
    pages and attention gathers through the page table
    (``kernels/paged_attention``).

    ``paged`` is a layer-bound attend hook (``PagedBatchView.bind``). A
    global layer passes ``window=None``, not ``LARGE_WINDOW``, so the
    kernel sees a real "no window". The hook takes no positions, so M-RoPE
    changes only q and k here. As in the JAX package, only the window
    reaches the hook: a llama4 local layer's ``block_local`` mask
    is not applied here, so past ``attn_chunk`` tokens a paged step
    attends globally where prefill and the contiguous decode do not."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"paged attention decodes one token, got S={S}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, S, KV, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, S, KV, hd)
    q, k = _rope(cfg, q, k, positions)
    window = None
    if cfg.sliding_window is not None and (cfg.layer_pattern == "swa"
                                           or is_local):
        window = int(cfg.sliding_window)
    out = paged.attend(q[:, 0], k[:, 0], v[:, 0], scale=_attn_scale(cfg),
                       window=window, softcap=cfg.attn_logit_softcap)
    return linear(out.reshape(B, S, H * hd).to(x.dtype), p["wo"])


# ------------------------------------------------------------------ MLA layer
def mla_defs(cfg: ModelConfig) -> dict:
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq": ParamDef((D, H * qd), ("residual", "tp")),
            "w_dkv": ParamDef((D, m.kv_lora_rank), ("residual", None)),
            "w_krope": ParamDef((D, m.qk_rope_head_dim), ("residual", None)),
            "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
            "w_uk": ParamDef((m.kv_lora_rank, H * m.qk_nope_head_dim),
                             (None, "tp")),
            "w_uv": ParamDef((m.kv_lora_rank, H * m.v_head_dim),
                             (None, "tp")),
            "wo": ParamDef((H * m.v_head_dim, D), ("tp", "residual"))}


def mla_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[dict],
              decode_pos: Optional[torch.Tensor],
              chunk: int = 1024) -> Tuple[torch.Tensor, dict]:
    """Multi-head Latent Attention, x [B,S,D]. The cache holds the
    compressed latents: ``c_kv`` [B, L, kv_lora_rank] and the shared RoPE
    key ``k_rope`` [B, L, qk_rope_head_dim].

    ``wq`` and ``wo`` go through ``linear`` (the matmul kernels); the
    latent projections ``w_dkv``, ``w_krope``, ``w_uk`` and ``w_uv`` are
    plain matmuls, as the reference computes them outside any kernel.

    Prefill (``cache=None``): k and v are up-projected from the latents
    and attention runs the ``flash_attention`` kernel at a query-key head
    dim of qk_nope + qk_rope and a value head dim of v_head_dim; the new
    cache comes out. Decode (``cache`` and ``decode_pos`` [B]): the rows
    at ``decode_pos`` are written IN PLACE, then the absorbed form:
    ``W_uk`` folded into q, :func:`online_attention` over the latents with
    one KV head (the reference computes that step in XLA), ``W_uv``
    applied after."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nd, rd, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    scale = (nd + rd) ** -0.5

    q = linear(x, p["wq"]).reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)    # [B,S,r]
    k_rope = (x @ p["w_krope"]).reshape(B, S, 1, rd)
    ang = rope_angles(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, ang)
    k_rope = apply_rope(k_rope, ang)

    if cache is not None and decode_pos is not None:
        write_rows(cache["c_kv"], decode_pos, c_kv[:, 0])
        write_rows(cache["k_rope"], decode_pos, k_rope[:, 0, 0])
        # absorbed decode: q_nope W_uk^T puts the query in latent space
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope,
                             p["w_uk"].reshape(r, H, nd))         # [B,S,H,r]
        q_cat = torch.cat([q_lat, q_rope], dim=-1)            # [B,S,H,r+rd]
        k_cat = torch.cat([cache["c_kv"][:, :, None, :].to(q_cat.dtype),
                           cache["k_rope"][:, :, None, :].to(q_cat.dtype)],
                          dim=-1)
        q_cat, = batch_layout(q_cat, decode=True)
        out_lat = online_attention(
            q_cat, k_cat, cache["c_kv"][:, :, None, :], positions,
            decode_pos + 1, causal=True, window=None, scale=scale,
            logit_cap=None, chunk=chunk)                      # [B,S,H,r] fp32
        out = torch.einsum("bshr,rhv->bshv", out_lat,
                           p["w_uv"].reshape(r, H, vd).to(torch.float32))
        out = linear(out.reshape(B, S, H * vd).to(x.dtype), p["wo"])
        return out, cache

    # prefill: k and v from the latents, the RoPE key shared by every head
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, nd)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, vd)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rd)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    qf, k, v = batch_layout(qf, k, v, decode=False)
    out = _prefill_attention(qf, k, v, positions, scale=scale,
                             causal=not cfg.is_encoder)
    out, = batch_layout(out.reshape(B, S, H * vd), decode=False)
    out = linear(out.to(x.dtype), p["wo"])
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
