"""QuantizedStore: int8 / int4 per-channel quantized swap units.

At BUILD time every large float leaf of a unit is quantized to symmetric
per-channel int8 (values + one fp32 scale per output channel, ~4x fewer
bytes than fp32) or packed int4 (``bits=4``, ~8x), so a swap-in moves
that many fewer bytes from storage. The file bytes are identical to the
JAX package's for the same params.

At SWAP-IN the whole payload is read in one sequential read (the pipeline
contract: every stage runs and COMPLETES on the loader thread, so the host
read of block i+1 overlaps block i's compute), then copied to the device
ONCE as one contiguous blob; the leaves are cut out of that blob as views
by offset (the 128-byte alignment of every segment makes every view
aligned). What happens next is the ``eager`` knob:

  * ``eager=True``: each quantized leaf is reconstructed on the device by
    the ``dequant_int8`` kernel (int4 carriers unpacked in the same pass);
    raw leaves are cloned out so the blob can go;
  * ``eager=False`` (the fused path): 2-D leaves under a fused-routable key
    come back as :class:`QuantizedTensor` views and stream through the
    fused dequant-matmul; quantized leaves the fused kernel cannot stream
    (embeddings, ...) are dequantized HERE in numpy on the loader
    ("unpack", in pieces on a pool of threads: :func:`widen`), cast to
    their dtype on the host and copied up on their own. The blob that goes
    up holds only the segments device leaves read (raw leaves, fusable
    payloads and their scales), packed on the host at the same alignment,
    so the device holds what the ledger charges (``resident_lazy``) and no
    payload of a host-widened leaf; none goes up when no leaf reads it.

Accounting (as in the JAX package): ``io_bytes`` is the quantized payload
size; ``ledger_bytes`` is the stored size with ``eager=True`` and the
mixed residency (payload + scales for QuantizedTensor leaves, logical fp
bytes for host-dequantized ones) with ``eager=False``; ``quantized_bytes``
is the payload delivered still quantized; ``nbytes`` stays LOGICAL.

What gets quantized: float leaves with ndim >= 2 and >= ``min_quant_size``
elements. 1-D leaves (norm gains, biases) and small tensors are stored raw.

``plan=`` assigns the bit-width PER UNIT: a ``{unit: 0|4|8}`` dict (0 =
raw fp) or any object with a ``bits_map()`` method returning one (a
``repro_torch.calibrate.PrecisionPlan``; duck-typed so this module never
imports the calibrate package). Units the plan does not name are stored
raw. :func:`unit_stored_nbytes` gives a unit's exact payload at a
bit-width without building the store.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.skeleton import (ALIGN, RunningCRC, _align, dtype_name,
                                       host_array, skeleton_of, torch_dtype)
from repro_torch.kernels.dequant import (dequant_int8, quantize_int4,
                                         quantize_int8, unpack_int4)
from repro_torch.kernels.qtensor import FUSED_WEIGHT_KEYS, QuantizedTensor
from repro_torch.store.base import BlockStore, UnitRead, flush, to_device
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

MIN_QUANT_SIZE = 1024       # elements; smaller leaves are stored raw

# keys whose 2-D weights stream through the fused dequant-matmul and may
# therefore stay quantized-resident
FUSED_STREAM_KEYS = FUSED_WEIGHT_KEYS | {"w"}

# per-unit bit-width labels for the byte accounting; 0 = raw/fp
BITS_PRECISION = {0: "fp", 8: "int8", 4: "int4"}

_FLOATS = ("float16", "bfloat16", "float32", "float64")


def quantizable(shape, dtype: str, min_quant_size: int = MIN_QUANT_SIZE
                ) -> bool:
    """The store's quantization predicate (module docstring)."""
    return (len(shape) >= 2 and int(np.prod(shape)) >= min_quant_size
            and dtype in _FLOATS)


def leaf_meta(leaf) -> Tuple[Tuple[int, ...], str, int]:
    """(shape, dtype name, nbytes) of a tensor or array leaf, no copy."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), dtype_name(leaf.dtype),
                leaf.numel() * leaf.element_size())
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype), arr.nbytes


def quantizable_leaf(leaf, min_quant_size: int = MIN_QUANT_SIZE) -> bool:
    """:func:`quantizable` of a leaf (tensor or numpy array): the form the
    calibration profiler asks of a unit's leaves."""
    shape, dname, _ = leaf_meta(leaf)
    return quantizable(shape, dname, min_quant_size)


def unit_stored_nbytes(params, bits: int,
                       min_quant_size: int = MIN_QUANT_SIZE) -> int:
    """Exact stored payload of one unit at a bit-width (0 = all raw)
    WITHOUT building the store: every segment pads to ALIGN, so the sum of
    aligned segment sizes equals the file size byte for byte. The
    precision policy packs against this table."""
    if bits not in (0, 4, 8):
        raise ValueError(f"bits must be 0, 4 or 8, got {bits}")
    total = 0
    for leaf in tree_leaves(params):
        shape, dname, nbytes = leaf_meta(leaf)
        if bits and quantizable(shape, dname, min_quant_size):
            rows = int(np.prod(shape[:-1]))
            cols = int(shape[-1])
            qrows = rows if bits == 8 else (rows + 1) // 2
            total += _align(qrows * cols) + _align(4 * cols)
        else:
            total += _align(nbytes)
    return total


def _float_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().to(torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def roundtrip_leaf(leaf, bits: int, min_quant_size: int = MIN_QUANT_SIZE):
    """One leaf as this store gives it back at ``bits``: a leaf the store
    would quantize comes back quantized and dequantized on the host in fp32
    exactly as a read does, cast to the leaf's dtype (a host tensor); any
    other leaf, and every leaf at ``bits=0``, comes back as it is."""
    shape, name, _ = leaf_meta(leaf)
    if not (bits and quantizable(shape, name, min_quant_size)):
        return leaf
    quantize = quantize_int8 if bits == 8 else quantize_int4
    q, s = quantize(_float_array(leaf))
    return widen(q, s, int(np.prod(shape[:-1])), bits,
                 torch_dtype(name)).reshape(shape)


def roundtrip(params, bits: int, min_quant_size: int = MIN_QUANT_SIZE):
    """The tree this store's quantization gives back at ``bits``
    (:func:`roundtrip_leaf` of every leaf): the reference for the fused
    and eager paths, and the perturbed unit of the calibration profiler."""
    return tree_map(lambda x: roundtrip_leaf(x, bits, min_quant_size),
                    params)


@dataclass(frozen=True)
class QLeaf:
    """One leaf inside a unit's payload file. ``scale_offset < 0`` marks a
    raw leaf; otherwise the leaf is quantized [rows, cols] (``rows`` =
    LOGICAL rows; the int4 carrier holds ceil(rows/2)) at ``offset`` with
    fp32 [cols] scales at ``scale_offset``. ``dtype`` is the ORIGINAL
    dtype; ``fusable`` marks leaves the fused kernel streams still
    quantized; ``bits`` is the leaf's bit-width (0 for raw)."""
    offset: int
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str
    scale_offset: int = -1
    rows: int = 0
    cols: int = 0
    fusable: bool = False
    bits: int = 0


_WIDEN_PIECE = 1 << 22      # elements a thread widens at a time
_widen_pool = None


def widen(qv: np.ndarray, sv: np.ndarray, rows: int, bits: int,
          dtype: torch.dtype) -> torch.Tensor:
    """The host widening of a quantized leaf: [rows, C] values (``qv``
    int8, or the int4 carrier of ``rows`` logical rows) times the fp32
    per-column scales ``sv`` in fp32, ``np.multiply(vals, sv, dtype=
    float32)``, then cast to ``dtype`` -> a host tensor. Done in pieces of
    rows on a pool of threads (numpy and the cast release the GIL):
    elementwise, so bitwise the whole-array result, and no fp32 copy of a
    leaf that is not fp32 is ever whole."""
    global _widen_pool
    C = sv.shape[0]
    out = torch.empty((rows, C), dtype=dtype)
    flat = out.numpy() if dtype == torch.float32 else None
    step = max(1, _WIDEN_PIECE // C)               # carrier rows a piece
    scales = sv[None, :]

    def piece(c0: int) -> None:
        c1 = min(c0 + step, qv.shape[0])
        if bits == 4:
            r0, r1 = 2 * c0, min(2 * c1, rows)
            vals = unpack_int4(qv[c0:c1], r1 - r0)
        else:
            r0, r1, vals = c0, c1, qv[c0:c1]
        if flat is not None:
            np.multiply(vals, scales, out=flat[r0:r1], dtype=np.float32)
        else:
            out[r0:r1].copy_(torch.from_numpy(
                np.multiply(vals, scales, dtype=np.float32)))

    starts = range(0, qv.shape[0], step)
    if len(starts) == 1:
        piece(0)
        return out
    if _widen_pool is None:
        _widen_pool = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="quant-widen")
    list(_widen_pool.map(piece, starts))
    return out


def _device_segments(buf: np.ndarray, leaves: List[QLeaf],
                     host_fp: Dict[int, torch.Tensor]):
    """The segments of ``buf`` that device leaves read (every leaf not in
    ``host_fp``: raw leaves, and quantized ones with their scales), packed
    into one buffer at ALIGN, and the leaves with their offsets remapped
    into it. The payload of a host-widened leaf is left out."""
    if not host_fp:
        return buf, leaves
    segs: List[Tuple[int, int]] = []
    out: List[QLeaf] = []
    size = 0

    def seg(off: int, n: int) -> int:
        nonlocal size
        at = size
        segs.append((off, n))
        size += _align(n)
        return at

    for i, ql in enumerate(leaves):
        if i in host_fp:
            out.append(ql)
            continue
        off = seg(ql.offset, ql.nbytes)
        soff = (seg(ql.scale_offset, 4 * ql.cols) if ql.scale_offset >= 0
                else -1)
        out.append(dataclasses.replace(ql, offset=off, scale_offset=soff))
    packed = np.zeros(size, np.uint8)
    at = 0
    for off, n in segs:
        packed[at:at + n] = buf[off:off + n]
        at += _align(n)
    return packed, out


@dataclass
class QuantMeta:
    leaves: List[QLeaf]
    stored_nbytes: int
    resident_lazy: int = 0
    precision_bytes: Dict[str, int] = None


class QuantizedStore(BlockStore):
    backend = "quant"

    def __init__(self, workdir: str, min_quant_size: int = MIN_QUANT_SIZE,
                 bits: int = 8, eager: bool = True, verify: bool = False,
                 plan=None, device="cpu"):
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        super().__init__(workdir, verify=verify, device=device)
        self.min_quant_size = min_quant_size
        self.bits = bits
        self.eager = eager
        bm = plan.bits_map() if hasattr(plan, "bits_map") else plan
        self.plan = dict(bm) if bm is not None else None
        if self.plan is not None:
            bad = {b for b in self.plan.values() if b not in (0, 4, 8)}
            if bad:
                raise ValueError(f"plan bit-widths must be 0|4|8, got {bad}")
            self.suffix = ".qm"
        else:
            self.suffix = ".q8" if bits == 8 else ".q4"
        self._qmeta: Dict[str, QuantMeta] = {}

    @property
    def precision(self) -> str:
        if self.plan is not None:
            return "mixed"
        return "int8" if self.bits == 8 else "int4"

    def _unit_bits(self, name: str) -> int:
        return self.bits if self.plan is None else self.plan.get(name, 0)

    # ------------------------------------------------------------ build
    def _write_unit(self, name: str, params: dict) -> None:
        bits_u = self._unit_bits(name)
        quantize = quantize_int8 if bits_u == 8 else quantize_int4
        flat, _ = tree_flatten_with_path(params)
        self.skeletons[name] = skeleton_of(params)
        qleaves: List[QLeaf] = []
        resident_lazy = 0
        pbytes = {p: 0 for p in BITS_PRECISION.values()}
        size, crc = 0, RunningCRC()
        # each segment goes to the file as it is made, its CRC32 taken on
        # the way (no copy of the unit's payload, no read back)
        with open(self._path(name), "wb") as fh:
            def put(a: np.ndarray) -> int:
                nonlocal size
                off = size
                for chunk in (np.ascontiguousarray(a).reshape(-1).view(
                        np.uint8), bytes((-(off + a.nbytes)) % ALIGN)):
                    crc.update(chunk)
                    fh.write(chunk)
                    size += len(chunk)
                return off

            try:
                for path, leaf in flat:
                    arr, dname = host_array(leaf)
                    seg0 = size
                    if bits_u and quantizable(arr.shape, dname,
                                              self.min_quant_size):
                        key = path[-1] if path else None
                        fusable = arr.ndim == 2 and key in FUSED_STREAM_KEYS
                        q, scales = quantize(_float_array(leaf))
                        off = put(q)
                        soff = put(scales)
                        rows = int(np.prod(arr.shape[:-1]))
                        qleaves.append(QLeaf(off, q.nbytes, tuple(arr.shape),
                                             dname, soff, rows, q.shape[1],
                                             fusable, bits_u))
                        resident_lazy += (q.nbytes + scales.nbytes if fusable
                                          else arr.nbytes)
                    else:
                        off = put(arr)
                        qleaves.append(QLeaf(off, arr.nbytes, tuple(arr.shape),
                                             dname))
                        resident_lazy += arr.nbytes
                    pbytes[BITS_PRECISION[qleaves[-1].bits]] += size - seg0
            finally:
                digest = crc.value()
        self.digests[name] = digest
        self._qmeta[name] = QuantMeta(qleaves, size, resident_lazy, pbytes)

    # ------------------------------------------------------------ read
    def read_unit(self, name: str) -> UnitRead:
        skel = self.skeletons[name]
        if skel.nbytes == 0:
            return self._empty_unit(name)
        meta = self._qmeta[name]
        lazy = not self.eager
        dev = self.device
        t0 = time.perf_counter()
        # read: ONE sequential read forces the whole payload host-resident
        # on the loader thread (a map would defer the storage traffic into
        # the device copy, where it can no longer overlap the executor)
        buf = np.fromfile(self._path(name), dtype=np.uint8)
        self._verify_payload(name, buf)
        t1 = time.perf_counter()
        # unpack: in lazy mode the quantized leaves the fused kernel cannot
        # stream dequantize here in numpy, on the otherwise idle loader
        host_fp: Dict[int, torch.Tensor] = {}
        for i, ql in enumerate(meta.leaves):
            if lazy and ql.scale_offset >= 0 and not ql.fusable:
                qv = buf[ql.offset:ql.offset + ql.nbytes].view(np.int8) \
                    .reshape(-1, ql.cols)
                sv = buf[ql.scale_offset:ql.scale_offset + 4 * ql.cols] \
                    .view(np.float32)
                host_fp[i] = widen(qv, sv, ql.rows, ql.bits,
                                   torch_dtype(ql.dtype))
        t2 = time.perf_counter()
        # dispatch: the blob goes up ONCE (if any leaf reads it) and the
        # leaves are views by offset; host-dequantized leaves go up alone,
        # already in their dtype (a host cast rounds as the device's does)
        buf, meta_leaves = _device_segments(buf, meta.leaves, host_fp)
        need_blob = len(host_fp) < len(meta_leaves)
        blob = to_device(torch.from_numpy(buf), dev) if need_blob else None
        leaves = []
        qbytes = 0
        for i, ql in enumerate(meta_leaves):
            dt = torch_dtype(ql.dtype)
            if i in host_fp:
                leaves.append(to_device(host_fp[i], dev).reshape(ql.shape))
                continue
            if ql.scale_offset < 0:                       # raw leaf
                v = blob[ql.offset:ql.offset + ql.nbytes].view(dt) \
                    .reshape(ql.shape)
                leaves.append(v if lazy else v.clone())
                continue
            q = blob[ql.offset:ql.offset + ql.nbytes].view(torch.int8) \
                .reshape(-1, ql.cols)
            s = blob[ql.scale_offset:ql.scale_offset + 4 * ql.cols] \
                .view(torch.float32)
            if lazy:                                      # stay quantized
                leaves.append(QuantizedTensor(q, s, ql.shape, ql.dtype,
                                              ql.bits))
                qbytes += ql.nbytes + 4 * ql.cols
                continue
            leaves.append(dequant_int8(q, s, dt, bits=ql.bits, rows=ql.rows)
                          .reshape(ql.shape))
        tree = tree_unflatten(skel.treedef, leaves)
        flush(dev)
        t3 = time.perf_counter()
        stored = meta.stored_nbytes
        ledger = meta.resident_lazy if lazy else stored
        stages = (("read", t0, t1), ("unpack", t1, t2), ("dispatch", t2, t3))
        return UnitRead(tree, stored, ledger, t1 - t0, t3 - t1,
                        quantized_bytes=qbytes, stages=stages,
                        precision_bytes={k: v for k, v in
                                         (meta.precision_bytes or {}).items()
                                         if v})

    # ------------------------------------------------------------ sizes
    def stored_nbytes(self, name: str) -> int:
        return self._qmeta[name].stored_nbytes if name in self._qmeta \
            else self.skeletons[name].nbytes

    def resident_nbytes(self, name: str) -> int:
        """Eager mode holds the stored payload convention; lazy mode the
        mixed residency."""
        if not self.eager and name in self._qmeta:
            return self._qmeta[name].resident_lazy
        return self.stored_nbytes(name)

    def meta_bytes(self) -> int:
        base = super().meta_bytes()
        return base + sum(64 + 72 * len(m.leaves)
                          for m in self._qmeta.values())

