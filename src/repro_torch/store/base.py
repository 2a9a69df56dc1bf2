"""Pluggable block-store tier: how a model's swappable units are laid out at
build time and how one unit is read back at swap-in.

SwapNet (paper §4-§5) removes the redundant memory operations from swap-in;
once those copies are gone the next bottleneck is the storage tier itself.
A :class:`BlockStore` owns exactly that tier. The engine
(:class:`repro_torch.core.swap_engine.SwapEngine`) asks its store for a
:class:`UnitRead` and does the bookkeeping.

Backends: ``MmapStore`` (zero-copy map of the unit file, one copy to the
device; ``assembly="dummy"`` is the w/o-mod-ske ablation arm),
``RawIOStore`` (read() + staging copy, the ``copy_in`` arm),
``DirectIOStore`` (O_DIRECT reads into an aligned buffer arena),
``QuantizedStore`` (int8 / packed int4 per-channel payloads) and
``FaultInjector`` (seeded storage faults around any of them).

Every read ends with its device work complete: :func:`flush` records an
event on the current stream (the engine's copy stream on the loader
thread) and waits for it, so the executor only ever receives a finished
unit. File naming is collision-free (:func:`escape_name`).
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.skeleton import Skeleton, assemble_np, write_flat
from repro_torch.errors import SwapCorruptionError


def escape_name(name: str) -> str:
    """Collision-free filename escaping: ``_`` -> ``__`` first, then
    ``/`` -> ``_.``: injective, so ``"a/b"`` and ``"a_b"`` never share a
    file."""
    return name.replace("_", "__").replace("/", "_.")


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """ONE copy of a host byte buffer to ``device`` on the current stream.
    A copy from pageable memory is synchronous; the caller flushes."""
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    out.copy_(host, non_blocking=True)
    return out


def flush(device: torch.device) -> None:
    """Complete the device work queued on the current stream: record an
    event and wait for it on this (the loader) thread."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


@dataclass
class UnitRead:
    """One unit's swap-in, as performed by a store backend: the store ->
    engine contract. ``params`` is the assembled tree on the device;
    ``io_bytes`` the bytes moved storage -> host; ``ledger_bytes`` what
    the ledger is charged; ``io_s``/``asm_s`` the fetch vs assembly split;
    ``quantized_bytes`` the payload delivered still quantized;
    ``precision_bytes`` io_bytes by stored precision (None: the whole read
    at the store's precision); ``stages`` the ``(stage, start, end)``
    spans ("read", "unpack", "dispatch") run on the loader thread."""
    params: Any
    io_bytes: int
    ledger_bytes: int
    io_s: float = 0.0
    asm_s: float = 0.0
    quantized_bytes: int = 0
    stages: Tuple[Tuple[str, float, float], ...] = ()
    precision_bytes: Optional[Dict[str, int]] = None


class BlockStore:
    """Interface + shared layout for per-unit block storage.

    ``build(units, workdir)`` serializes the units once (shared names
    stored once); ``read_unit(name)`` brings one unit storage -> host ->
    device, called only from the engine's loader thread; ``nbytes`` is the
    LOGICAL unit size, ``stored_nbytes`` its size on storage,
    ``resident_nbytes`` what one resident copy costs the ledger, and
    ``meta_bytes`` the resident skeleton overhead (paper Fig. 19a).
    ``open()`` prepares a store for reading (idempotent); a store SHARED by
    several engines must tolerate concurrent ``read_unit`` calls from their
    loader threads.

    ``raw_format`` marks the raw flat layout (one contiguous buffer per
    unit), which :meth:`attach` can read through another backend: how the
    engine's ablation ``mode`` reinterprets one set of files.

    The integrity tier: ``digests`` holds one CRC32 per unit file, taken at
    build time; with ``verify=True`` every read checks its payload before
    assembly and raises :class:`SwapCorruptionError` on a mismatch.
    """

    backend = "abstract"
    raw_format = False      # True: on-disk files are the raw flat layout
    suffix = ".bin"

    def __init__(self, workdir: str, verify: bool = False,
                 device="cpu"):
        self.workdir = workdir
        self.device = torch.device(device)
        self.skeletons: Dict[str, Skeleton] = {}
        self.order: List[str] = []
        self.verify = verify
        self.digests: Dict[str, int] = {}
        self.integrity_failures = 0

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, units: Sequence[Tuple[str, dict]], workdir: str,
              **opts) -> "BlockStore":
        os.makedirs(workdir, exist_ok=True)
        store = cls(workdir, **opts)
        for name, params in units:
            store.order.append(name)
            if name in store.skeletons:     # shared unit: stored once
                continue
            store._write_unit(name, params)
            if name not in store.digests:   # not taken while writing
                store._record_digest(name)
        return store.open()

    def _write_unit(self, name: str, params: dict) -> None:
        raise NotImplementedError

    def _write_raw(self, name: str, params: dict) -> None:
        """Shared raw layout: one contiguous flat buffer per unit, written
        leaf by leaf; the unit's digest is taken from the bytes on their
        way to the file (a 43.5 GB model is not read back to check it)."""
        with open(self._path(name), "wb") as fh:
            skel, crc = write_flat(params, fh)
        self.skeletons[name] = skel
        self.digests[name] = crc

    @classmethod
    def attach(cls, other: "BlockStore", **opts) -> "BlockStore":
        """A reader over ANOTHER store's already-built raw files (shared
        skeletons, order and digests; no rebuild), on its device."""
        if not (cls.raw_format and other.raw_format):
            raise TypeError(
                f"cannot attach {cls.__name__} to {type(other).__name__}: "
                "both ends must use the raw flat file format")
        store = cls(other.workdir, device=other.device, **opts)
        store.skeletons = other.skeletons
        store.order = other.order
        store.digests = other.digests
        store.verify = store.verify or other.verify
        return store.open()

    # ------------------------------------------------------------ integrity
    def _record_digest(self, name: str) -> None:
        crc = 0
        with open(self._path(name), "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        self.digests[name] = crc

    def _verify_payload(self, name: str, buf) -> None:
        """Check ``buf`` (the whole file payload) against the build-time
        digest; a no-op unless ``self.verify``."""
        if not self.verify:
            return
        want = self.digests.get(name)
        if want is None:
            return
        got = zlib.crc32(memoryview(np.ascontiguousarray(buf)))
        if got != want:
            self.integrity_failures += 1
            raise SwapCorruptionError(
                f"unit {name!r}: payload CRC32 {got:#010x} != recorded "
                f"{want:#010x} ({self.backend} store, "
                f"{self._path(name)})", unit=name)

    # ------------------------------------------------------------ read
    def open(self) -> "BlockStore":
        """Prepare the store for reading. Idempotent; returns self."""
        return self

    def read_unit(self, name: str) -> UnitRead:
        raise NotImplementedError

    def close(self) -> None:
        """Release what ``open()`` started (a no-op for most backends)."""

    def _empty_unit(self, name: str) -> UnitRead:
        skel = self.skeletons[name]
        return UnitRead(assemble_np(skel, np.zeros(0, np.uint8)), 0, 0)

    # ------------------------------------------------------------ sizes
    def _path(self, name: str) -> str:
        return os.path.join(self.workdir, escape_name(name) + self.suffix)

    def nbytes(self, name: str) -> int:
        return self.skeletons[name].nbytes

    def stored_nbytes(self, name: str) -> int:
        return self.skeletons[name].nbytes

    def resident_nbytes(self, name: str) -> int:
        return self.stored_nbytes(name)

    def meta_bytes(self) -> int:
        return sum(s.meta_bytes() for s in self.skeletons.values())


def as_reader(store: BlockStore, mode: str = "snet",
              gpu_dispatch: bool = False) -> BlockStore:
    """Resolve the engine's ablation ``mode`` against a built store.

    ``snet`` reads the store through its own backend; ``copy_in`` and
    ``dummy_asm`` (the paper's Fig. 15 ablation arms) reinterpret a
    raw-format store through the RawIO / dummy-assembly paths.
    """
    from repro_torch.store.mmap_store import MmapStore
    from repro_torch.store.rawio_store import RawIOStore
    if mode == "copy_in":
        return RawIOStore.attach(store, gpu_dispatch=gpu_dispatch)
    if mode == "dummy_asm":
        return MmapStore.attach(store, assembly="dummy")
    if mode != "snet":
        raise ValueError(f"unknown engine mode {mode!r}; choose from "
                         "'snet', 'copy_in', 'dummy_asm'")
    return store.open()
