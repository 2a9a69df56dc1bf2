"""MmapStore: the paper's zero-copy swap-in path.

Memory-maps the unit file (no page-cache staging copy), pays the ONE
irreducible host -> device copy of the whole flat buffer, then assembles
by reference: typed views into that single device allocation, O(depth)
pointer work. Swap-out is write-back-free: parameters are immutable, drop
references.

The map is opened copy-on-write (``mode="c"``): torch then sees a writable
array and the file can never be modified through it. Nothing writes to
the host tensor; it is only the source of the copy, and the map is
dropped before the read returns, so no live tensor aliases the file. A
copy from pageable memory is synchronous, so the "dispatch" stage also
carries the page-ins of the map (pinned staging is later performance
work).

``assembly="dummy"`` is the w/o-mod-ske ablation arm: the same I/O, but
framework-default assembly (:func:`~repro_torch.core.skeleton.assemble_dummy`:
a dummy unit on the device and one copy per tensor into it, 2x resident
while the unit is assembled).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.skeleton import assemble, assemble_dummy
from repro_torch.store.base import BlockStore, UnitRead, flush, to_device


class MmapStore(BlockStore):
    backend = "mmap"
    raw_format = True

    def __init__(self, workdir: str, assembly: str = "ref",
                 verify: bool = False, device="cpu"):
        if assembly not in ("ref", "dummy"):
            raise ValueError(f"unknown assembly {assembly!r}; choose from "
                             "'ref', 'dummy'")
        super().__init__(workdir, verify=verify, device=device)
        self.assembly = assembly

    def _write_unit(self, name: str, params: dict) -> None:
        self._write_raw(name, params)

    def resident_nbytes(self, name: str) -> int:
        n = self.skeletons[name].nbytes
        return 2 * n if self.assembly == "dummy" else n

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
        dev = to_device(host, self.device)
        if self.assembly == "dummy":
            params = assemble_dummy(skel, dev)    # dummy-unit copies
            extra = 2 * n
        else:
            params = assemble(skel, dev)          # views: zero copy
            extra = n
        flush(self.device)
        t3 = time.perf_counter()
        stages = (("read", t0, t1), ("unpack", t1, t2), ("dispatch", t2, t3))
        return UnitRead(params, n, extra, t1 - t0, t3 - t1, stages=stages)
