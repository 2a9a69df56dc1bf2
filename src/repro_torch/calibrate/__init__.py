"""Calibration pass + precision policy for per-unit mixed-precision
swapping (the JAX package's ``repro/calibrate``, ported).

1. :func:`profiler.profile_model` / :func:`profiler.profile_sequential`
   measure each swap unit's output error at int8 and int4 on a small
   calibration batch (a versioned ``SensitivityProfile``).
2. :func:`policy.assign_precisions` solves the per-unit int4 / int8 / fp
   assignment against a fidelity target (:class:`policy.PrecisionPlan`).
3. ``QuantizedStore(plan=...)`` writes each unit at its assigned bits.

:func:`calibrate_sequential` bundles 1 and 2 for a planned
``SwappedSequential`` (the conv workloads). :func:`calibrate_model` bundles
them for a model: it measures on a throwaway LOSSLESS (mmap) swapped
instance on the caller's device, since calibration must see the exact
weights. ``python -m repro_torch.calibrate``
is the CLI.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from repro_torch.calibrate.policy import (PLAN_VERSION, PRECISION_BITS,
                                          PRECISION_LADDER, PrecisionPlan,
                                          assign_precisions)
from repro_torch.calibrate.profiler import (PROFILE_VERSION,
                                            SensitivityProfile, profile_model,
                                            profile_sequential,
                                            unit_precision_bytes)

__all__ = [
    "PLAN_VERSION", "PROFILE_VERSION", "PRECISION_BITS", "PRECISION_LADDER",
    "PrecisionPlan", "SensitivityProfile", "assign_precisions",
    "calibrate_model", "calibrate_sequential", "calibration_batch",
    "profile_model", "profile_sequential", "unit_precision_bytes",
]

# small by design: calibration rides the production swap path, so its
# cost is (1 + 2q) swapped passes
CALIB_BATCH, CALIB_SEQ = 2, 16


def calibration_batch(cfg, batch: int = CALIB_BATCH, seq: int = CALIB_SEQ,
                      seed: int = 0) -> dict:
    """Deterministic synthetic prefill batch for an arch (numpy, from
    ``seed``): uniform token ids, or unit-normal frontend inputs for a
    model that takes features."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        return {"tokens": rng.integers(
            0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    return {"features": rng.standard_normal(
        (batch, seq, cfg.d_frontend)).astype(np.float32)}


def calibrate_sequential(sw, x, fidelity: float, method: str = "output",
                         seed: int = 0, min_quant_size: int = 1024,
                         headroom: float = 0.7
                         ) -> Tuple[SensitivityProfile, PrecisionPlan]:
    """Profile + assign for a planned SwappedSequential on input ``x``. It
    measures on ``sw`` itself, so ``sw`` should hold the exact weights (an
    mmap store)."""
    prof = profile_sequential(sw, x, method=method, seed=seed,
                              min_quant_size=min_quant_size)
    return prof, assign_precisions(prof, fidelity, headroom=headroom)


def calibrate_model(model, params: dict, fidelity: float,
                    batch: Optional[dict] = None, method: str = "output",
                    seed: int = 0, name: Optional[str] = None,
                    budget: Optional[int] = None, dm=None,
                    prefetch_depth: int = 2, min_quant_size: int = 1024,
                    headroom: float = 0.7, workdir: Optional[str] = None,
                    device="cuda"
                    ) -> Tuple[SensitivityProfile, PrecisionPlan]:
    """Profile + assign for a model.

    Builds a throwaway mmap SwappedModel on ``device`` (same ``name``
    namespace, so the plan's unit keys match the quant store the caller
    builds next), its store in a temporary directory (under ``workdir``
    when given), and sweeps it with :func:`profile_model`. ``budget`` /
    ``dm`` partition it when given; otherwise every unit is its own block.
    """
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel

    if batch is None:
        batch = calibration_batch(model.cfg, seed=seed)
    with tempfile.TemporaryDirectory(prefix="calibrate_", dir=workdir) as tmp:
        sm = SwappedModel(model, params, os.path.join(tmp, "calib_store"),
                          prefetch_depth=prefetch_depth, name=name,
                          store_backend="mmap", device=device)
        try:
            if budget is not None:
                first = next(iter(batch.values()))
                sm.partition(budget, dm or DelayModel(),
                             int(first.shape[0]), int(first.shape[1]))
            else:
                sm.set_plan(tuple(range(1, len(sm.units))))
            prof = profile_model(sm, batch, method=method, seed=seed,
                                 min_quant_size=min_quant_size)
        finally:
            sm.close()
    return prof, assign_precisions(prof, fidelity, headroom=headroom)
