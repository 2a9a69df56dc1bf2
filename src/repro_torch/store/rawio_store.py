"""RawIOStore: read()-based swap-in, the w/o-uni-add (``copy_in``) arm.

The standard framework load path the paper ablates against: read() lands
the unit in a page-cache copy, a staging copy materializes it in the
process heap, then the device copy: 2x resident bytes per unit. With
``gpu_dispatch=True`` a model dispatched through a GPU runtime adds its
own dispatch copy on the device (``.clone()``, the ``.to('cuda')`` of a
framework's dispatch), 3x. Kept as a first-class backend for ablation
parity and because on some storage tiers (network filesystems where mmap
page faults serialize) buffered read() is the faster channel.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.skeleton import assemble
from repro_torch.store.base import BlockStore, UnitRead, flush, to_device


class RawIOStore(BlockStore):
    backend = "rawio"
    raw_format = True

    def __init__(self, workdir: str, gpu_dispatch: bool = False,
                 verify: bool = False, device="cpu"):
        super().__init__(workdir, verify=verify, device=device)
        self.gpu_dispatch = gpu_dispatch

    def _write_unit(self, name: str, params: dict) -> None:
        self._write_raw(name, params)

    def resident_nbytes(self, name: str) -> int:
        return (3 if self.gpu_dispatch else 2) * self.skeletons[name].nbytes

    def read_unit(self, name: str) -> UnitRead:
        skel = self.skeletons[name]
        n = skel.nbytes
        if n == 0:
            return self._empty_unit(name)
        t0 = time.perf_counter()
        with open(self._path(name), "rb") as fh:      # read(): page-cache copy
            raw = fh.read()
        staged = np.frombuffer(raw, np.uint8).copy()  # staging copy
        self._verify_payload(name, staged)
        t1 = time.perf_counter()
        host = torch.from_numpy(staged)
        t2 = time.perf_counter()
        dev = to_device(host, self.device)            # device copy
        if self.gpu_dispatch:
            dev = dev.clone()                         # dispatch copy
            extra = 3 * n
        else:
            extra = 2 * n
        params = assemble(skel, dev)
        flush(self.device)
        t3 = time.perf_counter()
        stages = (("read", t0, t1), ("unpack", t1, t2), ("dispatch", t2, t3))
        return UnitRead(params, n, extra, t1 - t0, t3 - t1, stages=stages)
