"""Assembly by reference (paper §5): flat block buffers + skeletons.

The paper replaces the framework's *dummy model* (a same-size placeholder
that parameters are copied into, doubling peak memory) with a
**skeleton**: structure plus pointers, indexed identically to the flat
parameter file, so assembly is O(depth) pointer writes.

A block's parameters are stored as ONE contiguous byte buffer; the
:class:`Skeleton` is the treedef plus a list of (offset, shape, dtype)
refs. :func:`assemble` cuts typed views out of one uint8 tensor, which may
live on the card (the single swapped-in allocation) or on the host (a
memory map): never a second copy of the parameters. Offsets are aligned to
:data:`ALIGN` bytes, so every view starts on a boundary that suits its
dtype and the card's vector loads.

dtype strings follow numpy's names (``"float32"``, ``"bfloat16"``, ...);
``"bfloat16"`` has no numpy dtype, so its bytes travel as ``uint16``.
"""
from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.tree import TreeDef, tree_flatten, tree_unflatten

ALIGN = 128  # byte alignment per tensor (DMA- and vector-load-friendly)

DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "uint16": torch.uint16, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported dtype {name!r}") from None


def dtype_name(dt: torch.dtype) -> str:
    try:
        return _NAMES[dt]
    except KeyError:
        raise TypeError(f"unsupported dtype {dt}") from None


def host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a contiguous host numpy array carrying its bytes, plus its
    dtype name (bfloat16 tensors come back as their uint16 bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy(), name
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype)


@dataclass(frozen=True)
class Ref:
    offset: int
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        n = int(np.prod(self.shape, dtype=np.int64))
        return n * torch_dtype(self.dtype).itemsize


@dataclass
class Skeleton:
    """Obj{sket}: structure + pointers, no parameters."""
    treedef: TreeDef
    refs: List[Ref]
    nbytes: int

    def meta_bytes(self) -> int:
        """Resident footprint of the skeleton itself (paper: a few KB)."""
        return 64 + 48 * len(self.refs)


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def skeleton_of(tree) -> Skeleton:
    """The skeleton alone: layout metadata without the flat buffer."""
    leaves, treedef = tree_flatten(tree)
    refs, cursor = [], 0
    for leaf in leaves:
        arr, name = host_array(leaf)
        refs.append(Ref(cursor, tuple(arr.shape), name))
        cursor = _align(cursor + arr.nbytes)
    return Skeleton(treedef, refs, cursor)


def flatten_params(tree) -> Tuple[np.ndarray, Skeleton]:
    """Serialize a param tree into (host byte buffer, skeleton)."""
    skel = skeleton_of(tree)
    buf = np.zeros(skel.nbytes, np.uint8)
    for leaf, ref in zip(tree_flatten(tree)[0], skel.refs):
        arr, _ = host_array(leaf)
        buf[ref.offset:ref.offset + arr.nbytes] = arr.view(np.uint8).reshape(-1)
    return buf, skel


class RunningCRC:
    """The CRC32 of a stream of buffers, taken in order on one worker
    thread, so that it runs while the caller writes the next buffer
    (``zlib.crc32`` and file writes both release the GIL). Each buffer is
    held until its CRC is taken; :meth:`value` waits for the last one."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last = None

    def update(self, chunk) -> None:
        prev = self._last
        self._last = self._pool.submit(
            lambda: zlib.crc32(chunk, 0 if prev is None else prev.result()))

    def value(self) -> int:
        try:
            return 0 if self._last is None else self._last.result()
        finally:
            self._pool.shutdown()


def write_flat(tree, fh) -> Tuple[Skeleton, int]:
    """Write a param tree to the binary file ``fh`` in the layout of
    :func:`flatten_params` (the same bytes), leaf by leaf, so no host copy
    of the whole unit is made; returns the skeleton and the CRC32 of the
    bytes written (:class:`RunningCRC`)."""
    skel = skeleton_of(tree)
    crc, cursor = RunningCRC(), 0
    try:
        for leaf, ref in zip(tree_flatten(tree)[0], skel.refs):
            pad = bytes(ref.offset - cursor)
            arr, _ = host_array(leaf)
            data = arr.reshape(-1).view(np.uint8)
            for chunk in (pad, data):
                crc.update(chunk)
                fh.write(chunk)
            cursor = ref.offset + data.nbytes
        pad = bytes(skel.nbytes - cursor)
        crc.update(pad)
        fh.write(pad)
    finally:
        digest = crc.value()
    return skel, digest


def assemble(skel: Skeleton, buf: torch.Tensor) -> Any:
    """Assembly by reference: typed views into the flat uint8 ``buf``
    (the paper's ``dst = src``), on whatever device ``buf`` lives."""
    leaves = []
    for r in skel.refs:
        raw = buf[r.offset:r.offset + r.nbytes]
        leaves.append(raw.view(torch_dtype(r.dtype)).reshape(r.shape))
    return tree_unflatten(skel.treedef, leaves)


def assemble_np(skel: Skeleton, buf: np.ndarray) -> Any:
    """Host-side assembly by reference over a writable (or copy-on-write
    mapped) numpy byte buffer: zero copies."""
    return assemble(skel, torch.from_numpy(buf))


def assemble_dummy(skel: Skeleton, buf: torch.Tensor) -> Any:
    """ABLATION (w/o-mod-ske): the framework's default assembly. A dummy
    unit of the same size is allocated on ``buf``'s device and every
    parameter is copied into it, one copy per tensor, so the unit holds
    2x its bytes until ``buf`` is dropped."""
    leaves = []
    for r in skel.refs:
        src = buf[r.offset:r.offset + r.nbytes].view(torch_dtype(r.dtype))
        slot = torch.empty(r.shape, dtype=torch_dtype(r.dtype),
                           device=buf.device)
        slot.copy_(src.reshape(r.shape))          # parameter-wise copy
        leaves.append(slot)
    return tree_unflatten(skel.treedef, leaves)
