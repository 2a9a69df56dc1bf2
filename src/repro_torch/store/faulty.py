"""FaultInjector: deterministic storage-fault injection over any backend.

SwapNet re-reads weight blocks from storage on EVERY pass, so the storage
tier's failure modes — a worn SD card returning EIO, an NFS latency spike,
a torn read after power loss, silent bit rot — land directly in the serving
critical path. This wrapper makes those failures *reproducible*: it wraps a
built store of any backend and, on a seed-driven schedule, makes individual
``read_unit`` calls fail the way real storage fails. The rest of the stack
(loader retry/backoff, integrity verification, ledger drain, scheduler
degradation — see docs/ARCHITECTURE.md "Failure handling") is then tested
against the REAL read paths, not mocks.

Fault classes (relative weights via ``mix``; total probability ``p``):

  * ``io``      — the read raises :class:`SwapIOError` (device EIO / missing
                  file class);
  * ``latency`` — the read succeeds but only after a deterministic latency
                  spike (``latency_s`` scaled 0.5-1.5x by the seeded rng) —
                  exercises the per-read deadline path;
  * ``torn``    — the unit file is truncated mid-file before the inner
                  backend reads it (and restored afterwards): whatever the
                  backend raises — a short ``preadv``, a CRC mismatch, an
                  assembly size error — is normalized to
                  :class:`SwapIOError`, the short-read class;
  * ``corrupt`` — ONE BIT of the unit file is flipped before the inner read
                  (and restored afterwards): the backend's CRC32 integrity
                  check (``wrap`` forces ``verify=True`` on the inner store)
                  must catch it and raise :class:`SwapCorruptionError` —
                  the read travels the genuine end-to-end corruption path,
                  never a simulated one.

Tamper-and-restore is the load-bearing trick: faults are applied to the
on-disk bytes and undone in a ``finally``, so a retry of the same unit sees
a clean file (unless the schedule draws a new fault) and the chaos property
"outputs are bit-identical whenever retries eventually succeed" holds by
construction.

Determinism: one ``random.Random(seed)`` drives every draw, and draws
happen in ``read_unit`` call order. A single loader thread per engine makes
single-model runs exactly reproducible; the per-store lock serializes
multi-engine runs (fault COUNTS stay deterministic, interleaving may not).
``force(*kinds)`` pushes an explicit fault script consumed before the rng —
how the tests stage "fail twice, then succeed" without probability math.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Sequence, Tuple

from repro_torch.errors import SwapCorruptionError, SwapIOError
from repro_torch.store.base import BlockStore, UnitRead

FAULT_KINDS = ("io", "latency", "torn", "corrupt")
DEFAULT_MIX: Dict[str, float] = {
    "io": 0.35, "latency": 0.25, "torn": 0.15, "corrupt": 0.25}


class FaultInjector(BlockStore):
    """A :class:`BlockStore` that wraps another store and injects faults.

    Build directly through the registry (``backend="faulty"``) with the
    inner backend by name::

        store = build_store(units, workdir, backend="faulty",
                            inner="mmap", p=0.05, seed=1234)

    or wrap an already-built store with :meth:`wrap`. Skeletons, unit order
    and integrity digests are SHARED by reference with the inner store, so
    size accounting and runtime planning see the wrapped backend unchanged.
    """

    backend = "faulty"
    raw_format = False      # refuse as_reader re-interpretation: attaching a
    #                         plain backend to the same files would silently
    #                         bypass the injector

    def __init__(self, workdir: str, inner_store: Optional[BlockStore] = None,
                 p: float = 0.05, seed: int = 0,
                 mix: Optional[Dict[str, float]] = None,
                 latency_s: float = 0.05):
        if inner_store is None:
            raise TypeError("FaultInjector wraps a built store; use "
                            "FaultInjector.wrap(store, ...) or "
                            "build_store(..., backend='faulty', inner=...)")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability {p} outside [0, 1]")
        super().__init__(workdir, verify=True, device=inner_store.device)
        self.inner = inner_store
        # integrity ON: an injected bit flip must surface as
        # SwapCorruptionError, never as silently wrong weights
        self.inner.verify = True
        self.skeletons = inner_store.skeletons
        self.order = inner_store.order
        self.digests = inner_store.digests
        self.p = p
        self.seed = seed
        self.mix = dict(mix or DEFAULT_MIX)
        if not self.mix or any(k not in FAULT_KINDS for k in self.mix):
            raise ValueError(f"fault mix {self.mix} not over {FAULT_KINDS}")
        self.latency_s = latency_s
        self._rng = random.Random(seed)
        self._script: Deque[Optional[str]] = deque()
        self._lock = threading.Lock()
        # observability: per-class injected counts + total reads served
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.reads = 0

    # ------------------------------------------------------------ build/wrap
    @classmethod
    def build(cls, units: Sequence[Tuple[str, dict]], workdir: str,
              inner: str = "mmap", inner_opts: Optional[dict] = None,
              device="cpu", **opts) -> "FaultInjector":
        from repro_torch.store import build_store
        if inner == "faulty":
            raise ValueError("FaultInjector cannot wrap itself")
        store = build_store(units, workdir, backend=inner, device=device,
                            **(inner_opts or {}))
        return cls.wrap(store, **opts)

    @classmethod
    def wrap(cls, store: BlockStore, **opts) -> "FaultInjector":
        return cls(store.workdir, inner_store=store, **opts).open()

    def open(self) -> "FaultInjector":
        self.inner.open()
        return self

    # ------------------------------------------------------------ schedule
    def force(self, *kinds: Optional[str]) -> None:
        """Push an explicit fault script: each entry is consumed by the next
        ``read_unit`` call BEFORE the rng draw (None = force a clean read).
        FIFO; deterministic tests stage e.g. ``force("io", "io", None)``."""
        for k in kinds:
            if k is not None and k not in self.injected:
                raise ValueError(f"unknown fault kind {k!r}; choose from "
                                 f"{FAULT_KINDS} or None")
            self._script.append(k)

    def _draw(self) -> Optional[str]:
        if self._script:
            return self._script.popleft()
        if self._rng.random() >= self.p:
            return None
        total = sum(self.mix.values())
        r = self._rng.random() * total
        for kind, w in sorted(self.mix.items()):
            r -= w
            if r < 0:
                return kind
        return next(iter(sorted(self.mix)))

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    # ------------------------------------------------------------ read
    def read_unit(self, name: str) -> UnitRead:
        with self._lock:
            self.reads += 1
            kind = self._draw()
            if kind is None:
                return self.inner.read_unit(name)
            self.injected[kind] += 1
            if kind == "io":
                raise SwapIOError(
                    f"injected I/O error reading unit {name!r}", unit=name)
            if kind == "latency":
                time.sleep(self.latency_s * (0.5 + self._rng.random()))
                return self.inner.read_unit(name)
            if kind == "torn":
                return self._torn_read(name)
            return self._corrupt_read(name)

    def _torn_read(self, name: str) -> UnitRead:
        """Truncate the unit file mid-way, run the REAL inner read against
        it, restore. Every way the backend notices (short preadv, CRC
        mismatch, assembly size error) is the same storage fact — a short
        read — so it is normalized to SwapIOError here."""
        path = self.inner._path(name)
        size = os.path.getsize(path)
        if size < 2:        # nothing to tear; degrade to an I/O fault
            raise SwapIOError(f"injected torn read of unit {name!r} "
                              "(empty file)", unit=name)
        cut = max(1, size // 2)
        with open(path, "rb+") as fh:
            fh.seek(cut)
            tail = fh.read()
            fh.truncate(cut)
        try:
            try:
                self.inner.read_unit(name)
            except Exception as e:
                raise SwapIOError(
                    f"injected torn read of unit {name!r}: file cut to "
                    f"{cut}/{size} bytes ({type(e).__name__}: {e})",
                    unit=name) from e
            raise SwapIOError(     # a backend that missed a torn file has a
                f"injected torn read of unit {name!r} went UNDETECTED by "
                f"the {self.inner.backend} backend", unit=name)  # real bug
        finally:
            with open(path, "rb+") as fh:
                fh.seek(cut)
                fh.write(tail)

    def _corrupt_read(self, name: str) -> UnitRead:
        """Flip one bit of the unit file, run the real inner read (its CRC32
        check must reject the payload), restore. The corruption travels the
        genuine storage -> host path — if the integrity tier ever regresses,
        this surfaces as the UNDETECTED error below, not a green test."""
        path = self.inner._path(name)
        size = os.path.getsize(path)
        if size == 0:
            raise SwapIOError(f"injected corrupt read of unit {name!r} "
                              "(empty file)", unit=name)
        off = self._rng.randrange(size)
        bit = 1 << self._rng.randrange(8)
        with open(path, "rb+") as fh:
            fh.seek(off)
            orig = fh.read(1)
            fh.seek(off)
            fh.write(bytes([orig[0] ^ bit]))
        try:
            try:
                self.inner.read_unit(name)
            except SwapCorruptionError:
                raise                       # the expected, verified outcome
            except Exception as e:          # backend tripped before the CRC
                raise SwapIOError(
                    f"injected corruption in unit {name!r} at byte {off}: "
                    f"({type(e).__name__}: {e})", unit=name) from e
            raise SwapCorruptionError(
                f"injected bit flip in unit {name!r} (byte {off}, mask "
                f"{bit:#04x}) went UNDETECTED by the {self.inner.backend} "
                "backend integrity check", unit=name)
        finally:
            with open(path, "rb+") as fh:
                fh.seek(off)
                fh.write(orig)

    # ------------------------------------------------------------ delegation
    def _write_unit(self, name: str, params: dict) -> None:
        raise NotImplementedError("FaultInjector wraps a built store")

    def nbytes(self, name: str) -> int:
        return self.inner.nbytes(name)

    def stored_nbytes(self, name: str) -> int:
        return self.inner.stored_nbytes(name)

    def resident_nbytes(self, name: str) -> int:
        return self.inner.resident_nbytes(name)

    def meta_bytes(self) -> int:
        return self.inner.meta_bytes()

    def close(self) -> None:
        self.inner.close()

    @property
    def integrity_failures(self) -> int:        # type: ignore[override]
        return self.inner.integrity_failures

    @integrity_failures.setter
    def integrity_failures(self, value: int) -> None:
        # BlockStore.__init__ assigns 0 before ``inner`` exists; swallow it
        if getattr(self, "inner", None) is not None:
            self.inner.integrity_failures = value
