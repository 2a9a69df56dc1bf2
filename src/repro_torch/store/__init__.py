"""Pluggable block stores (the storage tier of the swap path).

Pick a backend by name::

    store = build_store(units, workdir, backend="quant", device="cuda")
    engine = SwapEngine(store)

Backends: ``mmap`` (zero-copy, lossless; ``assembly="dummy"`` is the
w/o-mod-ske ablation arm), ``rawio`` (read()-based, the ``copy_in``
ablation arm), ``quant`` (per-channel int8 / packed int4 units;
``eager=False`` keeps fused-routable weights quantized-resident),
``directio`` (O_DIRECT page-cache-bypassing reads into an aligned buffer
arena, with queue-depth control) and ``faulty`` (seeded fault injection
around any other backend: ``inner="mmap"``, ``p``, ``seed``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Type

from repro_torch.device import resolve_device
from repro_torch.store.base import BlockStore, UnitRead, as_reader, escape_name
from repro_torch.store.directio_store import DirectIOStore
from repro_torch.store.faulty import FaultInjector
from repro_torch.store.mmap_store import MmapStore
from repro_torch.store.quantized_store import QuantizedStore
from repro_torch.store.rawio_store import RawIOStore

STORE_BACKENDS: Dict[str, Type[BlockStore]] = {
    "mmap": MmapStore,
    "rawio": RawIOStore,
    "quant": QuantizedStore,
    "directio": DirectIOStore,
    "faulty": FaultInjector,
}


def build_store(units: Sequence[Tuple[str, dict]], workdir: str,
                backend: str = "mmap", device="cuda", **opts) -> BlockStore:
    """Serialize ``units`` under ``workdir`` through the named backend;
    reads land on ``device`` (without CUDA the default raises)."""
    if backend not in STORE_BACKENDS:
        raise ValueError(f"unknown store backend {backend!r}; "
                         f"choose from {sorted(STORE_BACKENDS)}")
    return STORE_BACKENDS[backend].build(units, workdir,
                                         device=resolve_device(device), **opts)


__all__ = ["BlockStore", "UnitRead", "MmapStore", "RawIOStore",
           "QuantizedStore", "DirectIOStore", "FaultInjector",
           "STORE_BACKENDS", "build_store", "as_reader", "escape_name"]
