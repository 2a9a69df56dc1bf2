"""Device-class deployment profiles, shipped as DATA.

A profile is a partial overlay onto the config defaults (see
``layering.resolve_config``: defaults -> profile -> env -> CLI), capturing
the memory/storage envelope of a device class — budget, store backend, swap
precision, executor count, cache/KV fractions — plus a reference workload
so ``python -m repro_torch.launch.serve --profile <name>`` runs end-to-end with
zero other flags. Everything here is overridable by the env
(``SWAPNET_*``) and CLI layers above it.

All three profiles default to ``reduce="smoke"`` models so they run on any
dev machine; on a real deployment pass ``--reduce full`` (or
``SWAPNET_REDUCE=full``) on top — the profile describes the DEVICE, the
reduce preset describes the model scale.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.errors import ConfigError

__all__ = ["PROFILES", "profile_overlay", "profile_names"]

# name -> {"description": one-liner for --help/docs, "overlay": config dict}
PROFILES: Dict[str, dict] = {
    # Microcontroller-scale (the arxiv 2101.08744 extreme): single tenant,
    # single executor, a budget far below the model, every byte fought for —
    # a calibrated MIXED-precision store (per-unit int4/int8/fp from the
    # sensitivity pass, repro_torch/calibrate/) streams through the fused
    # dequant-matmul, a serial (m=1) pipeline (no RAM for a second in-flight
    # block), and a minimal hot cache.
    "mcu": {
        "description": "MCU-scale: one tenant, 8 MB budget, calibrated "
                       "mixed-precision quantized store, serial (m=1) "
                       "pipeline",
        "overlay": {
            "arch": "qwen2.5-3b",
            "workload": {"requests": 2, "prompt_len": 16, "rounds": 2},
            "runtime": {
                "budget_mb": 8.0,
                "store": "quant",
                "precision": "mixed",
                "fidelity": 2e-2,
                "prefetch_depth": 1,
                "cache_frac": 0.1,
                "executors": 1,
            },
        },
    },
    # Edge-TPU-class accelerator board: two co-resident tenants under one
    # shared budget, two executors with priority classes + preemption — the
    # paper's §6 multi-DNN scenario as a deployable default.
    "edge-tpu": {
        "description": "edge accelerator: two tenants, 24 MB shared budget, "
                       "2 executors, priority classes 1/8 with preemption",
        "overlay": {
            "models": ["qwen2.5-3b", "gemma2-9b"],
            "workload": {"requests": 2, "prompt_len": 32, "rounds": 2,
                         "priorities": [1.0, 8.0]},
            "runtime": {
                "budget_mb": 24.0,
                "store": "mmap",
                "executors": 2,
                "cache_frac": 0.25,
                "prefetch_depth": 2,
            },
            "scheduler": {"preempt": True},
        },
    },
    # Workstation / edge server: roomy budget, O_DIRECT storage so swap
    # traffic stops thrashing the page cache, paged-KV continuous-batching
    # decode enabled alongside prefill tenants.
    "workstation": {
        "description": "workstation: two tenants, 64 MB budget, O_DIRECT "
                       "store, paged-KV continuous-batching decode enabled",
        "overlay": {
            "models": ["qwen2.5-3b", "gemma2-9b"],
            "workload": {"requests": 4, "prompt_len": 32, "rounds": 2,
                         "priorities": [1.0, 8.0]},
            "runtime": {
                "budget_mb": 64.0,
                "store": "directio",
                "executors": 2,
                "cache_frac": 0.2,
                "prefetch_depth": 3,
                "paged": True,
                "kv_frac": 0.2,
                "page_tokens": 16,
                "max_batch": 8,
            },
            "scheduler": {"preempt": True},
        },
    },
}


def profile_names() -> list:
    return sorted(PROFILES)


def profile_overlay(name: str) -> dict:
    """The named profile's config overlay; unknown name -> ConfigError."""
    if name not in PROFILES:
        import difflib
        close = difflib.get_close_matches(name, PROFILES, n=2, cutoff=0.4)
        hint = (f" — did you mean {' or '.join(repr(c) for c in close)}?"
                if close else "")
        raise ConfigError(f"unknown profile {name!r} "
                          f"(known: {profile_names()}){hint}")
    return PROFILES[name]["overlay"]
