"""Configuration schema for the repro framework.

One ``ModelConfig`` schema expresses all assigned architecture families
(dense / ssm / moe / hybrid / vlm / audio).  ``models/transformer.py`` consumes
these configs; ``configs/<arch>.py`` instantiate them with cited numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0           # routed experts
    top_k: int = 1
    n_shared: int = 0           # always-on shared experts
    d_expert: int = 0           # FFN hidden size per routed expert
    d_shared: int = 0           # FFN hidden size of the (merged) shared expert
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"
    capacity_factor: float = 1.25   # per-expert slot headroom (tokens beyond drop)


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"        # "mamba2" | "rwkv6"
    d_state: int = 64           # SSM state size (mamba2) / head size (rwkv6)
    head_dim: int = 64
    expand: int = 2             # d_inner = expand * d_model (mamba2)
    d_conv: int = 4             # depthwise conv window (mamba2)
    chunk: int = 128            # chunked-scan block size (train/prefill)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- attention flavour ------------------------------------------------
    attn_bias: bool = False                 # QKV bias (qwen2)
    rope_type: str = "rope"                 # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    sliding_window: Optional[int] = None    # SWA window (danube, gemma2 local)
    attn_chunk: Optional[int] = None        # llama4 iRoPE: block-local attention
    chunked_global_every: int = 4           # every k-th layer is global (llama4)
    layer_pattern: str = "global"           # global | swa | alt_local_global | chunked
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None   # gemma2 uses d_model/n_heads
    mla: Optional[MLAConfig] = None
    # --- mixture of experts -----------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- state space / linear attention ------------------------------------
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0   # zamba2: one shared attn block every k layers
    # --- modality / head ----------------------------------------------------
    is_encoder: bool = False     # hubert: bidirectional, no decode
    embed_inputs: bool = True    # False: inputs are frontend embeddings (audio)
    n_vision_tokens: int = 0     # vlm: patch embeddings prepended by the stub
    d_frontend: int = 0          # feature dim provided by the modality stub
    tie_embeddings: bool = True
    # --- misc ----------------------------------------------------------------
    act: str = "swiglu"          # swiglu | gelu
    norm_eps: float = 1e-6
    post_norms: bool = False     # gemma2 post-attn/post-ffn norms
    dtype: str = "bfloat16"
    quant_eligible: bool = True  # may the quantized swap store serve this
                                 # model? (per-channel units; opt out
                                 # where recurrent dynamics amplify weight
                                 # error — the runtime then falls back to
                                 # the exact mmap backend)
    swap_precision: str = "int8" # quantized swap-unit precision when the
                                 # quant store serves this model: "int8"
                                 # (127 steps/channel, ~4x fewer swap bytes
                                 # than fp32) or "int4" (packed two-per-
                                 # byte, ~8x, error bound max|w[:,c]|/14) —
                                 # per-arch by error tolerance; ignored by
                                 # exact backends and when quant_eligible
                                 # is False. A serve/runtime `precision`
                                 # override wins over this default.
    source: str = ""             # citation for the config numbers

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string. Drives segment construction in the model."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm",) or (self.ssm is not None and self.hybrid_attn_every == 0 and self.family == "ssm"):
                kinds.append(self.ssm.kind)
            elif self.hybrid_attn_every > 0:
                # zamba2: shared attn block replaces every k-th position
                kinds.append("shared_attn" if (i % self.hybrid_attn_every) == (self.hybrid_attn_every - 1) else self.ssm.kind)
            elif self.moe is not None:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def is_local_layer(self, i: int) -> bool:
        """True if layer i uses windowed/chunked (not global) attention."""
        if self.layer_pattern == "swa":
            return True
        if self.layer_pattern == "alt_local_global":
            return i % 2 == 0   # gemma2: even layers local
        if self.layer_pattern == "chunked":
            # llama4 iRoPE: every chunked_global_every-th layer is global
            return i % self.chunked_global_every != (self.chunked_global_every - 1)
        return False

    def supports_decode(self) -> bool:
        return not self.is_encoder

    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid state, or bounded (SWA/chunked)
        attention on most layers (global layers decode at O(S) per token)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.attn_chunk is not None and self.layer_pattern == "chunked":
            return True
        return self.sliding_window is not None and self.layer_pattern in ("swa", "alt_local_global")

    def n_params(self) -> int:
        """Approximate parameter count (for budgets, roofline MODEL_FLOPS)."""
        D, H, KV, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.resolved_head_dim, self.d_ff,
                                 self.vocab_size, self.n_layers)
        kinds = self.layer_kinds()
        total = V * D * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(kinds):
            if kind in ("mamba2", "rwkv6"):
                total += self._ssm_params()
                continue
            if kind == "shared_attn" and i != kinds.index("shared_attn"):
                continue  # shared weights counted once
            if self.mla is not None:
                m = self.mla
                qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += D * H * qd                       # q proj
                total += D * (m.kv_lora_rank + m.qk_rope_head_dim)   # kv down
                total += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                total += H * m.v_head_dim * D             # o proj
            else:
                total += D * H * hd + 2 * D * KV * hd + H * hd * D
            if kind == "moe" and self.moe is not None:
                e = self.moe
                total += D * e.n_routed                   # router
                total += e.n_routed * 3 * D * e.d_expert
                if e.n_shared:
                    total += 3 * D * (e.d_shared or e.d_expert * e.n_shared)
            else:
                n_mats = 3 if ("glu" in self.act or self.act == "swiglu") else 2
                total += n_mats * D * F
            total += 2 * D  # norms
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        full = self.n_params()
        per_expert = 3 * self.d_model * e.d_expert
        inactive = (e.n_routed - e.top_k) * per_expert * sum(
            1 for k in self.layer_kinds() if k == "moe")
        return full - inactive

    def _ssm_params(self) -> int:
        s = self.ssm
        D = self.d_model
        if s.kind == "rwkv6":
            # time-mix: r,k,v,g,o projections + decay lora + channel-mix
            return 5 * D * D + 2 * D * 64 + int(3.5 * D * D) + 8 * D
        d_inner = s.expand * D
        n_heads = d_inner // s.head_dim
        return (D * (2 * d_inner + 2 * s.d_state + n_heads)   # in_proj
                + s.d_conv * (d_inner + 2 * s.d_state)        # conv
                + 2 * n_heads + d_inner                       # A, dt, D skip
                + d_inner * D)                                # out proj

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (4 if hybrid unit needs it),
        d_model <= 512, <= 4 experts, small vocab/window."""
        d = min(self.d_model, 256)
        hd = 64
        n_heads = max(2, min(4, self.n_heads))
        n_kv = 1 if self.n_kv_heads == 1 else min(2, n_heads)
        kw = dict(
            name=self.name + "-reduced",
            n_layers=4 if self.hybrid_attn_every else 2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=None if self.sliding_window is None else 64,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            n_vision_tokens=16 if self.n_vision_tokens else 0,
            d_frontend=64 if self.d_frontend else 0,
        )
        if self.rope_type == "mrope":
            kw["mrope_sections"] = (8, 12, 12)   # sums to head_dim/2 = 32
        if self.attn_chunk is not None:
            kw["attn_chunk"] = 8

        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                                  qk_rope_head_dim=16, v_head_dim=32)
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_routed=4, top_k=min(2, self.moe.top_k),
                                d_expert=128, d_shared=128 if self.moe.n_shared else 0)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk=16)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str        # train | prefill | decode
