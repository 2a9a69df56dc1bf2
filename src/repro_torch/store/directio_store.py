"""DirectIOStore: O_DIRECT swap-in, page-cache-bypassing reads.

The mmap backend rides the kernel page cache: on a memory-constrained box
the page cache is exactly the memory the budget is trying to protect, and
under pressure the kernel reclaims it mid-pipeline. O_DIRECT moves unit
bytes storage -> user buffer with no page-cache copy: the read cost is
paid once, explicitly, on the loader thread, and the budget the
MemoryLedger enforces is the whole story.

Mechanics (the only backend with alignment constraints):

  * O_DIRECT needs the buffer address, the file offset and the byte count
    to be multiples of the logical block size (``ALIGNMENT`` = 4096).
    Unit files are padded to it at build time, and reads land in an
    :class:`AlignedArena`: page-aligned numpy buffers, over-allocated by
    one alignment unit and offset to the first aligned byte, reused
    round-robin, so steady-state swap-in does no host allocation.
  * ``queue_depth > 1`` splits a read into that many contiguous aligned
    extents issued concurrently (``os.preadv`` per worker).
  * Filesystems that reject O_DIRECT (tmpfs, some overlayfs) are detected
    at ``open()`` by probing a real unit file; the store then reads
    buffered into the same arena, and ``direct_io`` records which path is
    live. Accounting and stages are identical either way.

:meth:`DirectIOStore.read_unit` returns only once its bytes are off the
arena buffer: the device copy has run and
:func:`~repro_torch.store.base.flush` has waited for it (on the CPU,
``to_device`` copies too, so no returned tensor aliases the arena). So a
buffer is free again as soon as its read returns, and one buffer per
store (the largest unit's bytes of host memory) is enough. The store's
lock is held from the read until the copy is done, so loader threads of
engines that share a store take turns on it. The JAX package keeps a
ring of 4 buffers; with each read waiting for its copy, the extra three
would only hold host memory.

Accounting (the JAX package's, byte for byte): ``io_bytes`` is the
ALIGNED byte count issued to storage (the padded file size);
``nbytes`` / ``ledger_bytes`` stay logical.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.skeleton import assemble
from repro_torch.errors import SwapIOError
from repro_torch.store.base import BlockStore, UnitRead, flush, to_device

ALIGNMENT = 4096        # logical block size bound: address, offset, count


def _align_up(n: int, a: int = ALIGNMENT) -> int:
    return (n + a - 1) // a * a


class AlignedArena:
    """Pool of page-aligned reusable read buffers.

    ``take(nbytes)`` returns an aligned uint8 view of at least ``nbytes``
    (rounded up to the alignment), growing a slot when a unit is larger
    than anything seen before; slots rotate round-robin."""

    def __init__(self, depth: int = 1):
        if depth < 1:
            raise ValueError(f"arena depth {depth} < 1")
        self._bufs: List[Optional[np.ndarray]] = [None] * depth
        self._next = 0
        self.allocations = 0    # observability: steady state must not grow

    def _alloc(self, nbytes: int) -> np.ndarray:
        raw = np.zeros(nbytes + ALIGNMENT, dtype=np.uint8)
        off = (-raw.ctypes.data) % ALIGNMENT
        self.allocations += 1
        return raw[off:off + nbytes]

    def take(self, nbytes: int) -> np.ndarray:
        """An aligned buffer of >= nbytes (rounded up to the alignment)."""
        need = _align_up(max(nbytes, 1))
        i = self._next
        self._next = (self._next + 1) % len(self._bufs)
        buf = self._bufs[i]
        if buf is None or buf.nbytes < need:
            buf = self._alloc(max(need, ALIGNMENT))
            self._bufs[i] = buf
        return buf[:need]

    @property
    def host_bytes(self) -> int:
        """Host bytes the arena's buffers hold now."""
        return sum(b.nbytes + ALIGNMENT for b in self._bufs if b is not None)


class DirectIOStore(BlockStore):
    backend = "directio"
    raw_format = True

    def __init__(self, workdir: str, queue_depth: int = 4,
                 verify: bool = False, device="cpu"):
        if queue_depth < 1:
            raise ValueError(f"queue_depth {queue_depth} < 1")
        super().__init__(workdir, verify=verify, device=device)
        self.queue_depth = queue_depth
        self.arena = AlignedArena()
        # held from arena.take() until the device copy is done (and by the
        # probe, which reads into the arena too)
        self._arena_lock = threading.RLock()
        self.direct_io: Optional[bool] = None   # resolved by open()
        self._pool: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------ build
    def _write_unit(self, name: str, params: dict) -> None:
        self._write_raw(name, params)
        # pad the file to the alignment so O_DIRECT can read it whole
        path = self._path(name)
        size = os.path.getsize(path)
        pad = _align_up(size) - size
        if pad:
            with open(path, "ab") as fh:
                fh.write(b"\0" * pad)
            self.digests[name] = zlib.crc32(b"\0" * pad, self.digests[name])

    def open(self) -> "DirectIOStore":
        with self._arena_lock:
            if self.direct_io is None:
                self.direct_io = self._probe_direct()
        if self._pool is None and self.queue_depth > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.queue_depth,
                thread_name_prefix="directio")
        return self

    def close(self) -> None:
        """Stop the extent workers (a later read reopens them)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _probe_direct(self) -> bool:
        """O_DIRECT support is a property of the filesystem, not the OS:
        probe with a real read so tmpfs / overlay fall back cleanly."""
        probe = next((n for n in self.order if self.skeletons[n].nbytes), None)
        if probe is None or not hasattr(os, "O_DIRECT"):
            return False
        try:
            fd = os.open(self._path(probe), os.O_RDONLY | os.O_DIRECT)
        except OSError:
            return False
        try:
            os.preadv(fd, [self.arena.take(ALIGNMENT)[:ALIGNMENT]], 0)
            return True
        except OSError:
            return False
        finally:
            os.close(fd)

    # ------------------------------------------------------------ read
    def _read_into(self, path: str, buf: np.ndarray) -> None:
        """Fill ``buf`` (aligned, whole-file size) from ``path`` with
        ``queue_depth`` concurrent aligned extents; a short read (a torn
        or truncated file) raises :class:`SwapIOError`."""
        self.open()
        flags = os.O_RDONLY | (os.O_DIRECT if self.direct_io else 0)
        fd = os.open(path, flags)

        def issue(off: int, ln: int) -> None:
            got = os.preadv(fd, [buf[off:off + ln]], off)
            if got != ln:
                raise SwapIOError(f"short read of {path}: {got} of {ln} "
                                  f"bytes at offset {off}")

        try:
            total = buf.nbytes
            if self._pool is None or total <= ALIGNMENT * self.queue_depth:
                issue(0, total)
                return
            # contiguous aligned extents, one outstanding read per worker
            chunk = _align_up(-(-total // self.queue_depth))
            futs = [self._pool.submit(issue, off, min(chunk, total - off))
                    for off in range(0, total, chunk)]
            for f in futs:
                f.result()
        finally:
            os.close(fd)

    def read_unit(self, name: str) -> UnitRead:
        skel = self.skeletons[name]
        n = skel.nbytes
        if n == 0:
            return self._empty_unit(name)
        aligned = _align_up(n)
        with self._arena_lock:
            t0 = time.perf_counter()
            buf = self.arena.take(aligned)
            self._read_into(self._path(name), buf)
            # the digest covers the padded file (what storage delivered)
            self._verify_payload(name, buf)
            t1 = time.perf_counter()
            host = torch.from_numpy(buf[:n])
            t2 = time.perf_counter()
            # the copy must be off the arena buffer before the lock goes:
            # to_device copies (on the CPU too) and flush waits for it
            params = assemble(skel, to_device(host, self.device))
            flush(self.device)
            t3 = time.perf_counter()
        stages = (("read", t0, t1), ("unpack", t1, t2), ("dispatch", t2, t3))
        return UnitRead(params, aligned, n, t1 - t0, t3 - t1, stages=stages)

    def stored_nbytes(self, name: str) -> int:
        return _align_up(self.skeletons[name].nbytes)

    def resident_nbytes(self, name: str) -> int:
        """What stays resident is the device copy (logical bytes); the
        alignment padding only exists on storage and in the arena."""
        return self.skeletons[name].nbytes
