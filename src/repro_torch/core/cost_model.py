"""Delay abstractions (paper §6.1) + model info table (Table 2).

SwapNet exposes three per-block delays to schedulers:
    t_in  = alpha * s_i + beta * d_i + kappa   (swap-in DMA + assembly
                                                references + per-block fixed
                                                dispatch overhead)
    t_ex  = gamma * f_i                        (execution)
    t_out = eta * d_i                          (pointer reset + GC)
with (alpha, beta, gamma, eta) profiled once per device by linear regression
(Fig. 9). s_i = block bytes, d_i = parameter depth (# tensors), f_i = FLOPs.

``kappa`` is the intercept of the swap-in regression: the fixed cost every
block pays regardless of size — prefetch-future bookkeeping, the loader
thread hop, the jitted block call dispatch. The paper's linear model omits
it, which makes "more, smaller blocks" look free; with the intercept the
block-count search (``PartitionPlanner.best_partition``) has a real
optimum: finer plans expose a smaller cold first block (better pipeline
overlap) until the per-block overhead eats the gain.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import synchronize
from repro_torch.kernels.qtensor import is_quantized
from repro_torch.tree import tree_leaves


@dataclass
class LayerInfo:
    """One row of the model info table (paper Table 2)."""
    name: str
    size: int      # bytes (s contribution)
    depth: int     # parameter tensors (d contribution)
    flops: float   # forward FLOPs at the profiled shape (f contribution)


@dataclass
class DelayModel:
    alpha: float = 1.2e-9    # s / byte        (~0.8 GB/s swap-in channel)
    beta: float = 5.2e-5     # s / reference   (paper: 50-55 us per reference)
    gamma: float = 2.0e-11   # s / FLOP
    eta: float = 1.5e-5      # s / reference
    kappa: float = 2.5e-4    # s / block       (fixed swap-in dispatch cost)

    def t_in(self, size: float, depth: float) -> float:
        return self.alpha * size + self.beta * depth + self.kappa

    def t_ex(self, flops: float) -> float:
        return self.gamma * flops

    def t_out(self, depth: float) -> float:
        return self.eta * depth

    @staticmethod
    def fit(samples_in: Sequence[Tuple[float, float, float]],
            samples_ex: Sequence[Tuple[float, float]],
            samples_out: Sequence[Tuple[float, float]]) -> "DelayModel":
        """Linear regression over profiled samples (paper Fig. 9).

        samples_in:  (size, depth, measured_t_in) — fit WITH an intercept
                     column, so the per-block fixed cost ``kappa`` is
                     estimated from the same profile instead of assumed.
                     The regression minimizes RELATIVE error (rows weighted
                     1/t): timer noise scales with the measured latency, so
                     unweighted OLS lets the biggest blocks drown the
                     depth/intercept terms that only small blocks identify
        samples_ex:  (flops, measured_t_ex)
        samples_out: (depth, measured_t_out)
        """
        A = np.asarray([(s, d, 1.0) for s, d, _ in samples_in], np.float64)
        y = np.asarray([t for *_, t in samples_in], np.float64)
        w = 1.0 / np.maximum(y, 1e-12)
        (alpha, beta, kappa), *_ = np.linalg.lstsq(A * w[:, None], y * w,
                                                   rcond=None)
        # warm-page-cache profiles can fit a (meaningless) negative
        # bandwidth or intercept; clamp — the model must stay monotone
        alpha = max(float(alpha), 0.0)
        fx = np.asarray([f for f, _ in samples_ex], np.float64)
        ty = np.asarray([t for _, t in samples_ex], np.float64)
        gamma = float(fx @ ty / max(fx @ fx, 1e-30))
        dx = np.asarray([d for d, _ in samples_out], np.float64)
        oy = np.asarray([t for _, t in samples_out], np.float64)
        eta = float(dx @ oy / max(dx @ dx, 1e-30))
        return DelayModel(float(alpha), float(beta), gamma, eta,
                          max(float(kappa), 0.0))

    def calibrated(self, store, names: Optional[Sequence[str]] = None
                   ) -> "DelayModel":
        """Re-anchor ``alpha`` to a STORE's measured swap channel.

        The profiled coefficients describe one channel. Store backends
        change the per-byte cost structurally (the quantized store adds
        host unpack work per byte, rawio staging copies), and planning a
        backend with another backend's alpha puts the block-count search in
        the wrong regime: it under-costs fused swap-ins, concludes swap-in
        is nearly free and stops at a shallow plan whose large cold first
        block caps the overlap.

        Reads every non-empty unit once through ``store.read_unit`` (a warm
        page cache, so this measures the host-side channel cost: the read,
        the unpack, the copy to the device) and rescales ONLY alpha so the
        model's total swap-in time over the store equals the measured
        total, net of the depth / intercept terms, which keep their values:

            alpha' = max(0, (sum t - beta * sum d - kappa * n) / sum s)

        with s the unit's RESIDENT bytes, the currency ``resident_infos``
        feeds the planner. The clock stops once the store's device is done
        with the read (the JAX package's ``block_until_ready``)."""
        names = list(store.order) if names is None else list(names)
        t_sum = s_sum = d_sum = n_read = 0.0
        for name in names:
            if store.skeletons[name].nbytes == 0:
                continue
            t0 = time.perf_counter()
            r = store.read_unit(name)
            synchronize(store.device)
            t_sum += time.perf_counter() - t0
            s_sum += store.resident_nbytes(name)
            # a quantized-resident leaf is two tensors (values, scales),
            # as the JAX package's pytree of it counts
            d_sum += sum(2 if is_quantized(x) else 1
                         for x in tree_leaves(r.params))
            n_read += 1
        if s_sum <= 0:
            return self
        alpha = (t_sum - self.beta * d_sum - self.kappa * n_read) / s_sum
        return dataclasses.replace(self, alpha=max(alpha, 0.0))

    def r2_in(self, samples_in) -> float:
        """Coefficient of determination of :meth:`t_in` over
        ``(size, depth, measured_t_in)`` samples."""
        y = np.asarray([t for *_, t in samples_in])
        pred = np.asarray([self.t_in(s, d) for s, d, _ in samples_in])
        ss = np.sum((y - y.mean()) ** 2)
        return 1.0 - float(np.sum((y - pred) ** 2) / max(ss, 1e-30))

def resident_infos(infos: Sequence[LayerInfo], store,
                   names: Optional[Sequence[str]] = None) -> List[LayerInfo]:
    """Re-cost the info table in RESIDENT bytes so ``simulate_pipeline`` /
    the block-plan search see the working set the ledger will actually be
    charged: quantized-resident units (the fused swap path) cost their
    stored payload — 4-8x less than logical — so plans pack more layers per
    block under the same budget. ``names`` aligns rows with store unit
    names when they differ from ``LayerInfo.name``; ``min`` keeps a
    backend whose resident cost EXCEEDS logical planned at logical size."""
    names = [r.name for r in infos] if names is None else list(names)
    out = []
    for r, name in zip(infos, names):
        try:
            resident = store.resident_nbytes(name)
        except KeyError:
            out.append(r)
            continue
        out.append(dataclasses.replace(r, size=min(r.size, resident)))
    return out


def packing_density(plan) -> float:
    """Mean layers per block of a BlockPlan: the figure the mixed-precision
    policy maximizes (more layers per block = fewer, larger, better
    overlapped swap-ins; see ``repro_torch/calibrate/policy.py``)."""
    return plan.n_layers / plan.n_blocks


# ---------------------------------------------------------------- info table
def _numel(leaf) -> int:
    return leaf.numel() if hasattr(leaf, "numel") else int(leaf.size)


def _matmul_params(tree) -> int:
    return sum(_numel(l) for l in tree_leaves(tree) if getattr(l, "ndim", 0) >= 2)


def layer_flops(cfg: ModelConfig, kind: str, tree, batch: int, seq: int) -> float:
    """Forward FLOPs of one layer at (batch, seq). Matmuls: 2*params*tokens;
    attention adds the 4*B*S*S_kv*H*hd score/value term; MoE counts only
    active experts."""
    T = batch * seq
    mm = _matmul_params(tree)
    if kind in ("dense", "moe", "shared_attn") and cfg.moe is not None and kind == "moe":
        e = cfg.moe
        per_expert = 3 * cfg.d_model * e.d_expert
        mm = mm - e.n_routed * per_expert + e.top_k * per_expert
    f = 2.0 * mm * T
    if kind in ("dense", "moe", "shared_attn"):
        skv = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
        hd = cfg.resolved_head_dim
        f += 4.0 * batch * seq * skv * cfg.n_heads * hd / 2  # causal halves it
    elif kind in ("mamba2", "rwkv6"):
        s = cfg.ssm
        nh = (cfg.d_model * (s.expand if s.kind == "mamba2" else 1)) // s.head_dim
        state = s.d_state if s.kind == "mamba2" else s.head_dim
        f += 6.0 * T * nh * s.head_dim * state
    return f
