"""Pluggable block stores (the storage tier of the swap path).

Pick a backend by name::

    store = build_store(units, workdir, backend="quant", device="cuda")
    engine = SwapEngine(store)

Ported backends: ``mmap`` (zero-copy, lossless) and ``quant`` (per-channel
int8 / packed int4 units; ``eager=False`` keeps fused-routable weights
quantized-resident). ``rawio``, ``directio`` and ``faulty`` are not ported
yet.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Type

from repro_torch.device import resolve_device
from repro_torch.store.base import BlockStore, UnitRead, escape_name
from repro_torch.store.mmap_store import MmapStore
from repro_torch.store.quantized_store import QuantizedStore

STORE_BACKENDS: Dict[str, Type[BlockStore]] = {
    "mmap": MmapStore,
    "quant": QuantizedStore,
}
NOT_PORTED = ("rawio", "directio", "faulty")


def build_store(units: Sequence[Tuple[str, dict]], workdir: str,
                backend: str = "mmap", device="cuda", **opts) -> BlockStore:
    """Serialize ``units`` under ``workdir`` through the named backend;
    reads land on ``device`` (without CUDA the default raises)."""
    if backend in NOT_PORTED:
        raise NotImplementedError(f"store backend {backend!r} is not ported "
                                  f"yet; choose from {sorted(STORE_BACKENDS)}")
    if backend not in STORE_BACKENDS:
        raise ValueError(f"unknown store backend {backend!r}; "
                         f"choose from {sorted(STORE_BACKENDS)}")
    return STORE_BACKENDS[backend].build(units, workdir,
                                         device=resolve_device(device), **opts)


__all__ = ["BlockStore", "UnitRead", "MmapStore", "QuantizedStore",
           "STORE_BACKENDS", "build_store", "escape_name"]
