"""Config-driven model: the dense, moe, rwkv6 and hybrid (mamba2 +
shared attention) kinds, as decoders or (hubert) as a bidirectional
encoder.

The layer list (``cfg.layer_kinds()``) is grouped into *segments* of
consecutive identical kinds; each segment's params are stacked [n, ...],
the layout of the JAX package, so units, skeletons and store files line
up between the two. PyTorch runs eagerly, so a segment is a Python loop
over its layers (views of the stacked tensors) where the JAX package
scans. Per-layer variation that only changes masking (gemma2 local/global)
is a Python bool per layer.

A model is a stack of dense (attention + MLP) and moe (attention +
mixture of experts, ``models/moe.py``) layers, or all rwkv6 (time-mix +
channel-mix, ``models/ssm.py``), or zamba2's hybrid: Mamba2 layers
(``models/ssm.py``) with one shared attention block (a dense layer) at
every ``hybrid_attn_every``-th position. The shared block is one param
tree, ``params["shared_attn"]``, applied at each of its positions; its
segments are not scanned (``Segment.scanned`` False) and hold ``{}`` in
``params["segments"]``, the JAX package's tree. A config with ``mla``
(deepseek-v2) attends with Multi-head Latent Attention
(``attention.mla_apply``) in its dense and moe layers. A config with
``rope_type="mrope"`` (qwen2-vl) rotates q and k by three position
streams (``positions`` [B, S, 3]: temporal, height, width), broadcast
from the token index when the batch brings none.

The modality frontends are stubs, as in the JAX package: the batch
brings the vision or audio encoder's output and the model projects it
with one ``frontend`` matrix [d_frontend, D]. qwen2-vl's prefill replaces
the first ``n_vision_tokens`` rows of the token embedding by
``vision_embeds @ frontend``; hubert (``embed_inputs=False``, an
encoder: bidirectional attention, no decode) has no token embedding and
embeds ``features @ frontend``; in training its ``mask_emb`` replaces the
frames the batch's ``mask`` marks, and the loss weighs only those (masked
prediction, as in the JAX package). A
config with ``d_frontend`` whose family reads no frontend (llama4's
vision stub) still carries the ``frontend`` parameter, as the JAX
package's tree does; the forward never reads it.

Modes: "train" and "prefill" run full sequences; "train" builds no cache
and checkpoints each layer (``torch.utils.checkpoint``, the counterpart of
the JAX package's ``jax.checkpoint``), so backward recomputes a layer's
activations from its input; :meth:`Model.loss` is its token-chunked
cross-entropy. "decode" runs one token against a
decode cache (updated in place: K/V rows for dense layers, the latent rows
for MLA layers, the recurrent state for rwkv6 and mamba2 layers) or, for
GQA layers with a ``paged`` hook, through the paged KV cache. The decode
cache is a list per segment of leaf dicts; a scanned segment's leaves
carry its layers stacked in front [n, ...], a shared segment's (one
occurrence of the shared block, with K/V of its own) carry none, as in the
JAX package.

Sharded: :meth:`Model.param_specs`, :meth:`Model.cache_specs` and
:func:`input_pspecs` place params, cache and batch on a device mesh by the
JAX package's rules (``distributed/sharding.py``). With a mesh installed
(``set_mesh``) and DTensor inputs, the forward holds the layouts DTensor
cannot find alone (the residual stream batch-sharded, FSDP weights
gathered at use, attention and SSM math on whole sequences); without a
mesh those calls do nothing. On a mesh the kernels run on local shards,
the MoE dispatches expert-parallel, and the dry run's switches
(:data:`WINDOWED_KV_CACHE`, :data:`SEQ_PARALLEL_RESIDUAL`,
``attention.SHARDED_DECODE_AXIS``) select the reference's perf variants.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.skeleton import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (BATCH_AXES, P, axis_sizes,
                                              batch_axes, gather_fsdp,
                                              get_mesh, is_dtensor,
                                              maybe_constrain, pspec,
                                              specs_from_defs,
                                              stack_specs)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (layer_norm, mlp_apply, mlp_defs,
                                       rms_norm, softcap)
from repro_torch.models.params import ParamDef, init_from_defs, is_def
from repro_torch.tree import tree_map

LOSS_CHUNK = 512   # token chunk of the logsumexp loss (never [T, V] at once)
# The residual stream's layout on a mesh: batch over (pod, data), nothing
# else sharded. Each layer's input and each branch added to it are held to
# it (a no-op without a mesh): left alone, DTensor reduce-scatters a
# branch's partial sums over "model" onto the batch, which 512 devices do
# not divide at train_4k's 256 sequences.
RESIDUAL = P(BATCH_AXES, None, None)

# Two switches of the JAX package's dry run (``launch/dryrun.py`` sets
# them and resets them when a run ends). A ring-buffer KV cache for
# uniformly sliding-window archs (h2o-danube): the decode cache holds only
# the last ``sliding_window`` positions (slot = pos % window;
# ``attention._windowed_decode``) instead of the whole sequence.
WINDOWED_KV_CACHE = False
# Sequence parallelism on the residual stream: outside decode each scanned
# layer's input (the carry a train step checkpoints) is held split over
# "model" along the sequence, cutting the saved residual by the TP width
# for gathers inside the layer.
SEQ_PARALLEL_RESIDUAL = False


def _windowed_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """The decode cache's length: the window under ``WINDOWED_KV_CACHE``
    for an ``swa`` arch (at most ``seq_len``), else ``seq_len``."""
    if (WINDOWED_KV_CACHE and cfg.layer_pattern == "swa"
            and cfg.sliding_window is not None):
        return min(seq_len, cfg.sliding_window)
    return seq_len


@dataclass(frozen=True)
class Segment:
    kind: str            # dense | moe | mamba2 | rwkv6 | shared_attn
    n: int
    layer_ids: Tuple[int, ...]

    @property
    def scanned(self) -> bool:
        """False for a shared block's occurrence: its params are the one
        top-level tree, not a stacked segment."""
        return self.kind != "shared_attn"


def build_plan(cfg: ModelConfig) -> List[Segment]:
    kinds = cfg.layer_kinds()
    plan: List[Segment] = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        plan.append(Segment(kinds[i], j - i, tuple(range(i, j))))
        i = j
    return plan


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if not (kinds <= {"dense", "moe"} or kinds == {"rwkv6"}
            or kinds <= {"mamba2", "shared_attn"}):
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {sorted(kinds)} are not ported yet "
            f"(dense / moe stacks, all rwkv6, or mamba2 with shared "
            f"attention only)")


# ------------------------------------------------------------------ defs
def _layer_kind(kind: str) -> str:
    """The kind a layer computes as: a shared block's occurrence is a dense
    layer."""
    return "dense" if kind == "shared_attn" else kind


def layer_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind == "mamba2":
        return ssm_mod.mamba2_defs(cfg)
    if kind == "rwkv6":
        return ssm_mod.rwkv6_defs(cfg)
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    D = cfg.d_model
    norm = "zeros" if cfg.post_norms else "ones"
    d: Dict[str, Any] = {"ln1": ParamDef((D,), (None,), init=norm),
                         "ln2": ParamDef((D,), (None,), init=norm),
                         "attn": (attn_mod.mla_defs(cfg) if cfg.mla is not None
                                  else attn_mod.gqa_defs(cfg))}
    if cfg.post_norms:
        d["post_ln1"] = ParamDef((D,), (None,), init="zeros")
        d["post_ln2"] = ParamDef((D,), (None,), init="zeros")
    if kind == "moe":
        d["ffn"] = moe_mod.moe_defs(cfg)
    else:
        d["ffn"] = mlp_defs(cfg, D, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig) -> Tuple[dict, List[Segment]]:
    _check_supported(cfg)
    plan = build_plan(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "final_norm": ParamDef((D,), (None,),
                               init="zeros" if cfg.post_norms else "ones")}
    if cfg.embed_inputs:
        defs["embed"] = ParamDef((V, D), ("vocab", "residual"),
                                 init="small")
    if cfg.d_frontend:
        defs["frontend"] = ParamDef((cfg.d_frontend, D), (None, "residual"))
    if cfg.is_encoder:
        defs["mask_emb"] = ParamDef((D,), (None,), init="small")
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        defs["lm_head"] = ParamDef((D, V), ("residual", "vocab"),
                                   init="small")
    if any(not s.scanned for s in plan):
        defs["shared_attn"] = layer_defs(cfg, "dense")
    defs["segments"] = [layer_defs(cfg, s.kind) if s.scanned else {}
                        for s in plan]
    return defs, plan


# ------------------------------------------------------------------ layer
def apply_layer(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                positions: torch.Tensor, is_local: bool, cache, decode_pos,
                mode: str, paged=None):
    """Returns (x, new_cache, aux): ``aux`` is a moe layer's load-balance
    loss, 0.0 for every other kind. ``paged`` (decode only) is a layer-bound
    paged-attention hook (``serving/paged_kv.PagedBatchView.bind``):
    attention K/V land in the page pool instead of a contiguous cache, and
    ``new_cache`` is None. In decode, ``cache`` is updated in place and
    returned. An MLA layer takes its own branch first, as in the JAX
    package (the paged cache refuses MLA models). ``shared_attn`` runs as
    ``dense``."""
    kind = _layer_kind(kind)
    if get_mesh() is not None:      # FSDP: the layer's weights at use
        p = tree_map(gather_fsdp, p)
    if kind == "mamba2":
        return _apply_mamba2(cfg, p, x, cache, mode) + (0.0,)
    if kind == "rwkv6":
        return _apply_rwkv6(cfg, p, x, cache, mode) + (0.0,)
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h = rms_norm(x, p["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
    if cfg.mla is not None:
        a_out, new_cache = attn_mod.mla_apply(cfg, p["attn"], h, positions,
                                              cache, decode_pos)
    elif paged is not None and mode == "decode":
        a_out = attn_mod.gqa_apply_paged(cfg, p["attn"], h, positions,
                                         is_local, paged)
        new_cache = None
    else:
        a_out, new_cache = attn_mod.gqa_apply(cfg, p["attn"], h, positions,
                                              is_local, cache, decode_pos)
    if cfg.post_norms:
        a_out = rms_norm(a_out, p["post_ln1"], cfg.norm_eps, plus_one=True)
    x = x + maybe_constrain(a_out, RESIDUAL)
    h = rms_norm(x, p["ln2"], cfg.norm_eps, plus_one=cfg.post_norms)
    aux = 0.0
    if kind == "moe":
        f_out, aux = moe_mod.moe_apply(cfg, p["ffn"], h)
    else:
        f_out = mlp_apply(cfg, p["ffn"], h)
    if cfg.post_norms:
        f_out = rms_norm(f_out, p["post_ln2"], cfg.norm_eps, plus_one=True)
    return x + maybe_constrain(f_out, RESIDUAL), new_cache, aux


def _apply_mamba2(cfg: ModelConfig, p: dict, x: torch.Tensor, cache,
                  mode: str):
    """A mamba2 layer; its cache is {'h', 'conv'}: the SSM state and the
    causal conv's tail. As in the JAX package, the layer's ``norm`` is
    never read: the block adds the SSD of x itself to x."""
    h0 = cs = None
    if cache is not None:
        h0, cs = cache["h"], cache["conv"]
    if mode == "decode":
        out, (h, conv) = ssm_mod.mamba2_step(cfg, p, x, h0, cs)
    else:
        out, (h, conv) = ssm_mod.mamba2_chunked(cfg, p, x, h0, cs)
    new = {"h": h, "conv": conv}
    if cache is not None and mode == "decode":
        for name, t in new.items():
            cache[name].copy_(t)
        new = cache
    return x + maybe_constrain(out, RESIDUAL), new


def _apply_rwkv6(cfg: ModelConfig, p: dict, x: torch.Tensor, cache,
                 mode: str):
    """An rwkv6 layer; its cache is {'S', 'shift1', 'shift2'}: the WKV
    state and the two token shifts."""
    S0 = sh1 = sh2 = None
    if cache is not None:
        S0, sh1, sh2 = cache["S"], cache["shift1"], cache["shift2"]
    xn = layer_norm(x, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
    if mode == "decode":
        out, (S, sh1n) = ssm_mod.rwkv6_time_mix_step(cfg, p, xn, S0, sh1)
    else:
        out, (S, sh1n) = ssm_mod.rwkv6_time_mix_chunked(cfg, p, xn, S0, sh1)
    x = x + maybe_constrain(out, RESIDUAL)
    xn = layer_norm(x, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
    out, sh2n = ssm_mod.rwkv6_channel_mix(cfg, p, xn, sh2)
    new = {"S": S, "shift1": sh1n, "shift2": sh2n}
    if cache is not None and mode == "decode":
        for name, t in new.items():
            cache[name].copy_(t)
        new = cache
    return x + maybe_constrain(out, RESIDUAL), new


def cache_struct(cfg: ModelConfig, kind: str, batch: int,
                 max_len: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """One layer's decode cache, leaf name -> (shape, dtype): K/V rows
    [B, max_len, KV, hd] for a dense or moe layer, or with MLA the latent
    rows ``c_kv`` [B, max_len, kv_lora_rank] and ``k_rope`` [B, max_len,
    qk_rope_head_dim]; for rwkv6 the fp32 WKV state [B, nh, hd, hd] and the
    token shifts [B, 1, D], for mamba2 the fp32 SSM state h [B, nh, hd, ds]
    and the conv's tail [B, d_conv - 1, d_inner + 2 ds]: the state leaves
    do not grow with the sequence. A shared block's occurrence has a dense
    layer's K/V."""
    dt = torch_dtype(cfg.dtype)
    kind = _layer_kind(kind)
    if kind == "mamba2":
        d_inner, nh, ds = ssm_mod.mamba2_dims(cfg)
        return {"h": ((batch, nh, cfg.ssm.head_dim, ds), torch.float32),
                "conv": ((batch, cfg.ssm.d_conv - 1, d_inner + 2 * ds), dt)}
    if kind == "rwkv6":
        nh, hd = ssm_mod.rwkv6_dims(cfg)
        shift = ((batch, 1, cfg.d_model), dt)
        return {"S": ((batch, nh, hd, hd), torch.float32),
                "shift1": shift, "shift2": shift}
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": ((batch, max_len, m.kv_lora_rank), dt),
                "k_rope": ((batch, max_len, m.qk_rope_head_dim), dt)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": (shape, dt), "v": (shape, dt)}


def alloc_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      device: torch.device, lead: tuple = ()) -> dict:
    """Zeros of :func:`cache_struct`, with ``lead`` axes in front."""
    return {name: torch.zeros(lead + shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_struct(cfg, kind, batch,
                                                  max_len).items()}


def layer_slice(stacked, j: int):
    """Layer j of a stacked segment tree (views)."""
    return tree_map(lambda a: a[j], stacked)


def _lead(seg: Segment) -> tuple:
    """The layer axis a segment's cache leaves carry in front."""
    return (seg.n,) if seg.scanned else ()


def _project(a: torch.Tensor, w: torch.Tensor,
             dt: torch.dtype) -> torch.Tensor:
    """``(a @ w).astype(dt)`` with JAX's promotion of mixed float
    operands (bf16 with fp32 multiplies in fp32)."""
    pt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(pt), w.to(pt)).to(dt)


def _run_layer(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
               positions: torch.Tensor, is_local: bool, cache, decode_pos,
               mode: str, scanned: bool = True):
    """:func:`apply_layer`; in "train" mode checkpointed (backward
    recomputes the layer from its input) and without a cache. On a mesh
    the residual stream enters every layer batch-sharded, nothing else
    sharded, or with ``SEQ_PARALLEL_RESIDUAL`` outside decode a scanned
    layer's input also split over "model" along the sequence, as the JAX
    package holds its scan's carry (a no-op without a mesh)."""
    if SEQ_PARALLEL_RESIDUAL and mode != "decode" and scanned:
        x = maybe_constrain(x, P(BATCH_AXES, "model", None))
    else:
        x = maybe_constrain(x, RESIDUAL)
    if mode != "train":
        return apply_layer(cfg, kind, p, x, positions, is_local, cache,
                           decode_pos, mode)
    x, aux = checkpoint(_train_layer, cfg, kind, p, x, positions, is_local,
                        use_reentrant=False)
    return x, None, aux


def _train_layer(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, is_local: bool):
    """What each checkpoint runs and recomputes: (x, aux)."""
    x, _, aux = apply_layer(cfg, kind, p, x, positions, is_local, None, None,
                            "train")
    return x, aux


def _chunk_nll(h: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
               w_head: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Summed weighted negative log-likelihood of one chunk of positions:
    h [B, c, D], targets and weights [B, c]."""
    logits = softcap(h.to(torch.float32) @ w_head.to(torch.float32), cap)
    if not is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        # on vocab-sharded logits DTensor gathers the whole [B, c, V] for
        # logsumexp, and gather's masked partial fails to reduce; a max, a
        # sum of exps and a where over the vocab give the same two values,
        # each a partial over the vocab shards. Each is reduced to
        # batch-sharded rows: left alone, DTensor reduce-scatters it over
        # "model", and backward then gathers the [B, c, V] gradient to meet
        # the vocab-sharded logits
        rows = P(BATCH_AXES, None, None)
        m = maybe_constrain(logits.detach().amax(-1, keepdim=True), rows)
        se = maybe_constrain(torch.exp(logits - m).sum(-1, keepdim=True),
                             rows)
        lse = (m + torch.log(se))[..., 0]
        hit = (torch.arange(logits.shape[-1], device=logits.device)
               == targets[..., None])
        tgt = maybe_constrain(torch.where(hit, logits, 0.0).sum(-1),
                              P(BATCH_AXES, None))
    return torch.sum((lse - tgt) * weights)


# ------------------------------------------------------------------ model
class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.defs, self.plan = model_defs(cfg)

    # ---------------- params
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params (fp32) from per-path ``torch.Generator``s on
        ``device`` (without CUDA the default raises). A swapped model's
        params only feed the store, which serializes from the host: pass
        ``device="cpu"`` for those."""
        device = resolve_device(device)
        parts = dict(self.defs)
        seg_defs = parts.pop("segments")
        params = init_from_defs(parts, seed, device=device)
        params["segments"] = [
            init_from_defs(sdefs, seed + 1000 + si, lead=(seg.n,),
                           device=device) if seg.scanned else {}
            for si, (seg, sdefs) in enumerate(zip(self.plan, seg_defs))]
        return params

    def param_struct(self, dtype: Optional[str] = None) -> dict:
        """The params' tree as meta tensors (no allocation), stacked
        segments [n, ...] as :meth:`init` makes them; ``dtype`` overrides
        the fp32 storage (e.g. "bfloat16" for serving weights)."""
        dt = torch_dtype(dtype) if dtype else torch.float32

        def mk(d: ParamDef, lead=()):
            return torch.empty(lead + tuple(d.shape), dtype=dt, device="meta")
        parts = dict(self.defs)
        seg_defs = parts.pop("segments")
        st = tree_map(mk, parts, is_leaf=is_def)
        st["segments"] = [
            tree_map(lambda d, _n=seg.n: mk(d, (_n,)), sdefs, is_leaf=is_def)
            if seg.scanned else {} for seg, sdefs in zip(self.plan, seg_defs)]
        return st

    def param_specs(self) -> dict:
        """PartitionSpecs matching :meth:`param_struct`: each def's
        ``spec()``, a replicated layer axis in front of stacked segments."""
        parts = dict(self.defs)
        seg_defs = parts.pop("segments")
        specs = specs_from_defs(parts)
        specs["segments"] = [
            stack_specs(specs_from_defs(d), 1) if s.scanned else {}
            for s, d in zip(self.plan, seg_defs)]
        return specs

    def cast(self, params: dict) -> dict:
        """Float params to the compute dtype (storage stays fp32)."""
        dt = torch_dtype(self.cfg.dtype)
        return tree_map(lambda a: a.to(dt) if a.is_floating_point() else a,
                        params)

    # ---------------- embedding / io
    def _embed(self, params: dict, batch: dict, mode: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x [B,S,D], positions [B,S], or [B,S,3] with M-RoPE).
        The frontend projections are plain matmuls, as the JAX package
        computes them outside any kernel, in the promoted dtype of their
        operands (the JAX package's ``@``), then cast to the compute
        dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        if cfg.embed_inputs:
            tokens = batch["token" if mode == "decode" else "tokens"]
            # on a mesh, DTensor's vocab-parallel embedding (the backward
            # of an index into the sharded table fails in torch 2.11); its
            # masked partial sum is reduced here, onto the residual
            # stream's layout, before anything else reads it
            x = maybe_constrain(F.embedding(
                tokens.long(), gather_fsdp(params["embed"])).to(dt),
                RESIDUAL)
            if (cfg.family == "vlm" and mode != "decode"
                    and "vision_embeds" in batch):
                v = _project(batch["vision_embeds"],
                             gather_fsdp(params["frontend"]), dt)
                x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
        else:
            x = _project(batch["features"], gather_fsdp(params["frontend"]),
                         dt)
            if cfg.is_encoder and mode == "train" and "mask" in batch:
                x = torch.where(batch["mask"][..., None],
                                params["mask_emb"].to(x.dtype), x)
        x = maybe_constrain(x, RESIDUAL)
        if cfg.final_logit_softcap is not None:   # gemma-style embed scaling
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        if "positions" in batch:
            return x, batch["positions"]
        if mode == "decode":
            positions = batch["pos"][:, None]
        else:
            B, S = x.shape[:2]
            positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.rope_type == "mrope":
            positions = positions[..., None].expand(*positions.shape, 3)
        return x, positions

    @staticmethod
    def _head_weight(params: dict) -> torch.Tensor:
        """``lm_head``, or ``embed.T`` when tied. On a mesh it is gathered
        over "data" and stays vocab-sharded (FSDP gathers a weight at use):
        left data-sharded, DTensor contracts over the sharded D and
        all-reduces the whole [B, S, V] logits instead."""
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].T
        return maybe_constrain(gather_fsdp(w),
                               pspec(w.shape, (None, "vocab")))

    def _head(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        w = self._head_weight(params)
        logits = h.to(torch.float32) @ w.to(torch.float32)
        return softcap(logits, self.cfg.final_logit_softcap)

    # ---------------- steps
    def forward(self, params: dict, batch: dict, mode: str = "prefill",
                cache: Optional[list] = None):
        """Full-sequence forward. Returns (hidden, cache, aux): the cache is
        a list per segment of each layer's cache leaves stacked [n, ...],
        or for a shared block's occurrence its leaves as they are
        (``cache_struct``); None in "train" mode, which checkpoints each
        layer instead. ``aux`` sums the moe layers' load-balance losses
        (0.0 without one)."""
        cfg = self.cfg
        params = self.cast(params)
        x, positions = self._embed(params, batch, mode)
        decode_pos = batch.get("pos") if mode == "decode" else None
        new_cache, aux = [], 0.0
        for si, seg in enumerate(self.plan):
            if not seg.scanned:
                lid = seg.layer_ids[0]
                x, c_new, a = _run_layer(cfg, seg.kind, params["shared_attn"],
                                         x, positions, cfg.is_local_layer(lid),
                                         None if cache is None else cache[si],
                                         decode_pos, mode, scanned=False)
                new_cache.append(c_new)
                aux = aux + a
                continue
            stacked = params["segments"][si]
            layers = []
            for j, lid in enumerate(seg.layer_ids):
                c = (None if cache is None else
                     {name: t[j] for name, t in cache[si].items()})
                x, c_new, a = _run_layer(cfg, seg.kind,
                                         layer_slice(stacked, j), x,
                                         positions, cfg.is_local_layer(lid),
                                         c, decode_pos, mode)
                layers.append(c_new)
                aux = aux + a
            if cache is not None:
                new_cache.append(cache[si])
            elif mode != "train":
                new_cache.append({name: torch.stack([c[name] for c in layers])
                                  for name in layers[0]})
        x = rms_norm(maybe_constrain(x, RESIDUAL), params["final_norm"],
                     cfg.norm_eps, plus_one=cfg.post_norms)
        return x, (None if mode == "train" else new_cache), aux

    def loss(self, params: dict, batch: dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Token-chunked cross-entropy, the JAX package's ``Model.loss``:
        the "train" forward, then per ``LOSS_CHUNK`` tokens of the sequence
        the fp32 head (``lm_head``, or ``embed.T`` when tied, from the
        uncast params), the final softcap, logsumexp minus the target's
        logit. Where there is more than one chunk each is checkpointed, so
        backward recomputes its [B, chunk, V] logits and the peak holds one
        chunk's, never [T, V]; a single chunk is the whole of the logits
        either way, and is not recomputed. An encoder weighs the positions its ``mask`` marks; the
        sum is divided by max(sum(weights), 1) and the moe aux loss added.
        Returns (loss, {"loss", "aux", "tokens"})."""
        cfg = self.cfg
        h, _, aux = self.forward(params, batch, mode="train")
        B, S, _ = h.shape
        targets = batch["targets"].long()
        if cfg.is_encoder:
            weights = batch["mask"].to(torch.float32)
        else:
            weights = torch.ones((B, S), dtype=torch.float32,
                                 device=h.device)
        w_head = self._head_weight(params)
        chunk = min(LOSS_CHUNK, S)
        if S % chunk != 0:
            chunk = S
        if chunk == S:
            total = _chunk_nll(h, targets, weights, w_head,
                               cfg.final_logit_softcap)
        else:
            total = 0.0
            for c0 in range(0, S, chunk):
                sl = slice(c0, c0 + chunk)
                total = total + checkpoint(
                    _chunk_nll, h[:, sl], targets[:, sl], weights[:, sl],
                    w_head, cfg.final_logit_softcap, use_reentrant=False)
        denom = torch.clamp(weights.sum(), min=1.0)
        loss = total / denom + aux
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        return loss, {"loss": loss, "aux": aux, "tokens": denom}

    def prefill(self, params: dict, batch: dict):
        h, cache, _ = self.forward(params, batch, mode="prefill")
        return self._head(params, h[:, -1:]), cache

    def cache_struct(self, batch: int, max_len: int) -> list:
        """Per segment, leaf name -> (shape, dtype) of the decode cache:
        ``cache_struct`` with the layers stacked in front [n, ...], none
        for a shared block's occurrence; the window's length under
        ``WINDOWED_KV_CACHE`` (:func:`_windowed_cache_len`)."""
        max_len = _windowed_cache_len(self.cfg, max_len)
        return [{name: (_lead(seg) + shape, dt) for name, (shape, dt) in
                 cache_struct(self.cfg, seg.kind, batch, max_len).items()}
                for seg in self.plan]

    def alloc_cache(self, batch: int, max_len: int, device="cuda") -> list:
        """Zero decode cache: per segment the leaves of
        :meth:`cache_struct`."""
        device = resolve_device(device)
        max_len = _windowed_cache_len(self.cfg, max_len)
        return [alloc_layer_cache(self.cfg, seg.kind, batch, max_len, device,
                                  lead=_lead(seg)) for seg in self.plan]

    def cache_specs(self, shape: ShapeConfig, mesh=None) -> list:
        """PartitionSpecs matching :meth:`cache_struct` at the shape's batch
        and sequence. Batch over (pod, data) where divisible; the cache
        sequence dim is sharded over "model" (flash-decoding style), and
        over every remaining axis when batch is 1 (long_500k) so no axis
        idles. Axis sizes come from ``mesh`` (a DeviceMesh), else the
        single pod's (16, 16)."""
        cfg = self.cfg
        B = shape.global_batch
        sizes = axis_sizes(mesh) if mesh is not None else {"data": 16,
                                                           "model": 16}
        cand = tuple(a for a in ("pod", "data") if a in sizes)
        bsz = math.prod(sizes[a] for a in cand) if cand else 1
        if cand and B % bsz == 0 and B > 1:
            batch_ax, seq_extra = cand, ()
        elif B % sizes.get("data", 16) == 0 and B > 1:
            batch_ax, seq_extra = "data", ()
        else:
            batch_ax = None
            seq_extra = tuple(a for a in ("pod", "data") if a in sizes)
        seq_ax = seq_extra + ("model",) if batch_ax is None else "model"
        out = []
        for seg in self.plan:
            lead = (None,) if seg.scanned else ()
            kind = _layer_kind(seg.kind)
            if kind == "mamba2":
                nh = ssm_mod.mamba2_dims(cfg)[1]
                hax = "model" if nh % 16 == 0 else None
                out.append({"h": P(*lead, batch_ax, hax, None, None),
                            "conv": P(*lead, batch_ax, None, None)})
            elif kind == "rwkv6":
                nh = ssm_mod.rwkv6_dims(cfg)[0]
                hax = "model" if nh % 16 == 0 else None
                out.append({"S": P(*lead, batch_ax, hax, None, None),
                            "shift1": P(*lead, batch_ax, None, None),
                            "shift2": P(*lead, batch_ax, None, None)})
            elif cfg.mla is not None:
                out.append({"c_kv": P(*lead, batch_ax, seq_ax, None),
                            "k_rope": P(*lead, batch_ax, seq_ax, None)})
            else:
                out.append({"k": P(*lead, batch_ax, seq_ax, None, None),
                            "v": P(*lead, batch_ax, seq_ax, None, None)})
        return out

    def decode_step(self, params: dict, cache: list, batch: dict):
        """batch: {'token': [B,1], 'pos': [B]} (+ 'positions' [B,1,3] for
        M-RoPE). ``cache`` (from :meth:`alloc_cache`) is updated in place
        and returned."""
        h, cache, _ = self.forward(params, batch, mode="decode", cache=cache)
        return self._head(params, h), cache


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Every model input of the shape's mode, name -> (shape, dtype), the
    JAX package's ``input_specs`` (int32 ids and positions)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if shape.mode == "decode":
        d = {"token": ((B, 1), i32), "pos": ((B,), i32)}
        if cfg.rope_type == "mrope":
            d["positions"] = ((B, 1, 3), i32)
        return d
    d = {}
    if cfg.embed_inputs:
        d["tokens"] = ((B, S), i32)
    else:
        d["features"] = ((B, S, cfg.d_frontend), dt)
    if shape.mode == "train":
        d["targets"] = ((B, S), i32)
        if cfg.is_encoder:
            d["mask"] = ((B, S), torch.bool)
    if cfg.family == "vlm":
        d["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_frontend), dt)
        d["positions"] = ((B, S, 3), i32)
    return d


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """PartitionSpecs matching :func:`input_specs`: batch over (pod, data)
    where the batch divides their extent, else replicated."""
    ba = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    specs = {}
    for k, (shp, _) in input_specs(cfg, shape).items():
        trailing = (None,) * (len(shp) - 1)
        b = ba if shp[0] % math.prod(sizes[a] for a in ba) == 0 else None
        specs[k] = P(b, *trailing)
    return specs
