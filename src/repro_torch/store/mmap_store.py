"""MmapStore: the paper's zero-copy swap-in path.

Memory-maps the unit file (no page-cache staging copy), pays the ONE
irreducible host -> device copy of the whole flat buffer, then assembles
by reference: typed views into that single device allocation, O(depth)
pointer work. Swap-out is write-back-free: parameters are immutable, drop
references.

The map is opened copy-on-write (``mode="c"``): torch then sees a writable
array and the file can never be modified through it. Nothing writes to
the host tensor; it is only the source of the copy. A copy from pageable
memory is synchronous, so the "dispatch" stage also carries the page-ins
of the map (pinned staging is later performance work).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.skeleton import assemble
from repro_torch.store.base import BlockStore, UnitRead, flush, to_device


class MmapStore(BlockStore):
    backend = "mmap"

    def _write_unit(self, name: str, params: dict) -> None:
        self._write_raw(name, params)

    def read_unit(self, name: str) -> UnitRead:
        skel = self.skeletons[name]
        n = skel.nbytes
        if n == 0:
            return self._empty_unit(name)
        t0 = time.perf_counter()
        buf = np.memmap(self._path(name), dtype=np.uint8, mode="c")
        self._verify_payload(name, buf)
        t1 = time.perf_counter()
        host = torch.from_numpy(buf)
        t2 = time.perf_counter()
        params = assemble(skel, to_device(host, self.device))
        flush(self.device)
        t3 = time.perf_counter()
        stages = (("read", t0, t1), ("unpack", t1, t2), ("dispatch", t2, t3))
        return UnitRead(params, n, n, t1 - t0, t3 - t1, stages=stages)
