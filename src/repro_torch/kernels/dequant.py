"""Per-channel quantizers (int8 + packed int4) and the device dequant kernel.

The QuantizedStore writes swap units as quantized values + one fp32 scale
per output channel (~4x fewer stored bytes than fp32 at int8, ~8x at
int4). In its eager mode, swap-in copies only the quantized payload to the
card and reconstructs the fp parameters there with :func:`dequant_int8`.

Layout: values are [R, C] int8 where C is the channel (last) axis of the
original tensor and R the flattened rest; ``scales`` is [C] fp32. Output is
``out[r, c] = values[r, c] * scales[c]`` cast to the target dtype.

int4 carrier layout (``pack_int4`` / ``unpack_int4``, bit-exact contract):
two 4-bit two's-complement values share one int8 carrier byte; row pair
(2r, 2r+1) of the logical [R, C] grid maps to carrier row r with the EVEN
row in the low nibble and the ODD row in the high nibble. Odd R pads one
zero row. The card's kernel reads the carrier directly (``bits=4``): it
takes carrier row r // 2 and the nibble by the parity of r, so the unpack
and the multiply are one pass over the carrier.

Error bounds: quantization is symmetric round-to-nearest, so a round trip
reproduces x within ``scale_c / 2``: ``max|x[:, c]| / 254`` per channel at
int8, ``max|x[:, c]| / 14`` at int4.

The host quantizers are numpy and write bytes identical to the JAX
package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._build import (LaunchCounter, check, library,
                                        refuse_grad)

OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


# ------------------------------------------------------------ host quantizers
def _channel_grid(arr: np.ndarray) -> np.ndarray:
    x = np.asarray(arr, np.float32)
    return x.reshape(-1, x.shape[-1]) if x.ndim >= 2 else x.reshape(1, -1)


def _quantize(arr: np.ndarray, limit: int):
    """Symmetric per-channel quantization to [-limit, limit] over the last
    axis: scale = max|x| / limit (1.0 for a zero channel), values
    round-half-to-even(x / scale) clipped, int8. The JAX package's numpy
    arithmetic (``np.rint`` of an fp32 quotient) in torch ops, which run on
    every host core: each step is exact or one IEEE fp32 rounding, so the
    bytes are numpy's. max|x| is max(max x, -min x), exact, with no |x|
    copy, and the quotient is rounded and clipped in place: one fp32
    temporary the size of x."""
    x2 = _channel_grid(arr)
    if not (x2.flags.writeable and x2.flags.c_contiguous):
        x2 = np.array(x2, order="C")
    x = torch.from_numpy(x2)
    amax = torch.maximum(x.amax(dim=0), x.amin(dim=0).neg_())
    scales = torch.where(amax > 0.0, amax / float(limit),
                         torch.ones_like(amax))
    q = torch.div(x, scales[None, :])
    q.round_().clamp_(-limit, limit)
    return q.to(torch.int8).numpy(), scales.numpy()


def quantize_int8(arr: np.ndarray):
    """Build-time host quantizer: symmetric per-channel int8. Channels are
    the LAST axis; the rest flattens to rows. Returns (values int8 [R, C],
    scales fp32 [C]). Zero channels get scale 1.0, so dequant is exact
    there."""
    return _quantize(arr, 127)


def quantize_int4(arr: np.ndarray):
    """Build-time host quantizer: symmetric per-channel int4, packed.
    Returns (carrier int8 [ceil(R/2), C], scales fp32 [C])."""
    q, scales = _quantize(arr, 7)
    return pack_int4(q), scales


def pack_int4(q: np.ndarray) -> np.ndarray:
    """[R, C] int4-valued int8 -> [ceil(R/2), C] int8 carrier (two's
    complement nibbles: even row -> low, odd row -> high; odd R pads 0)."""
    R, C = q.shape
    if R % 2:
        q = np.concatenate([q, np.zeros((1, C), np.int8)], axis=0)
    u = q.view(np.uint8) & 0xF
    return ((u[1::2] << 4) | u[0::2]).view(np.int8)


def unpack_int4(carrier: np.ndarray, rows: int) -> np.ndarray:
    """Host inverse of :func:`pack_int4`: [Rp, C] carrier -> [rows, C]
    sign-extended int8 values (the zero pad row, if any, is sliced off)."""
    s = carrier.view(np.int8)
    out = np.empty((2 * s.shape[0], s.shape[1]), np.int8)
    np.right_shift(s, 4, out=out[1::2])                     # high nibble
    low = (carrier.view(np.uint8) << 4).view(np.int8)
    np.right_shift(low, 4, out=out[0::2])                   # low nibble
    return out[:rows]


def unpack_int4_tensor(carrier: torch.Tensor, rows: int) -> torch.Tensor:
    """Tensor inverse of :func:`pack_int4`, on any device. Each nibble is
    sign-extended as ``(n ^ 8) - 8``."""
    qi = carrier.to(torch.int32)
    low = ((qi & 0xF) ^ 8) - 8
    high = (((qi >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([low, high], dim=1).reshape(2 * carrier.shape[0],
                                                  carrier.shape[1])
    return out[:rows].to(torch.int8)


# ------------------------------------------------------------ dequant
def _logical_rows(values: torch.Tensor, bits: int, rows: Optional[int]) -> int:
    if values.ndim != 2:
        raise ValueError(f"values must be 2-D, got {tuple(values.shape)}")
    if bits == 8:
        if rows is not None and rows != values.shape[0]:
            raise ValueError(f"rows={rows} but int8 values have "
                             f"{values.shape[0]} rows")
        return values.shape[0]
    if bits != 4:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    rows = 2 * values.shape[0] if rows is None else rows
    if -(-rows // 2) != values.shape[0]:
        raise ValueError(f"an int4 carrier of {values.shape[0]} rows cannot "
                         f"hold {rows} logical rows")
    return rows


def dequant_int8_plain(values: torch.Tensor, scales: torch.Tensor,
                       out_dtype=torch.float32, *, bits: int = 8,
                       rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: unpack (int4), then one fp32 multiply."""
    rows = _logical_rows(values, bits, rows)
    vals = unpack_int4_tensor(values, rows) if bits == 4 else values
    return (vals.to(torch.float32)
            * scales.to(torch.float32)[None, :]).to(out_dtype)


def dequant_int8(values: torch.Tensor, scales: torch.Tensor,
                 out_dtype=torch.float32, *, bits: int = 8,
                 rows: Optional[int] = None) -> torch.Tensor:
    """values [R, C] int8 (``bits=8``) or the [ceil(R/2), C] int4 carrier
    (``bits=4``, ``rows`` = R), scales [C] fp32 -> [R, C] ``out_dtype``.

    A CUDA tensor launches the kernel (``csrc/dequant.cu``) or raises; a
    CPU tensor takes :func:`dequant_int8_plain`."""
    R = _logical_rows(values, bits, rows)
    C = values.shape[1]
    if tuple(scales.shape) != (C,):
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"{C} channels")
    if values.device.type == "cpu":
        return dequant_int8_plain(values, scales, out_dtype, bits=bits,
                                  rows=R)
    if values.device.type != "cuda":
        raise ValueError(f"dequant_int8: unsupported device {values.device}")
    refuse_grad("dequant_int8", scales)
    if values.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequant_int8 takes int8 values and fp32 scales, "
                        f"got {values.dtype} and {scales.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"dequant_int8 writes {sorted(map(str, OUT_DTYPES))}, "
                        f"not {out_dtype}")
    if scales.device != values.device:
        raise ValueError("values and scales lie on different devices")
    if not (values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_int8 takes contiguous values and scales")
    out = torch.empty((R, C), dtype=out_dtype, device=values.device)
    if out.numel() == 0:
        return out
    err = library().repro_dequant(
        values.data_ptr(), scales.data_ptr(), out.data_ptr(), R, C, bits,
        OUT_DTYPES[out_dtype],
        torch.cuda.current_stream(values.device).cuda_stream)
    check(err, "dequant kernel launch")
    launches.bump((R, C, bits, str(out_dtype).replace("torch.", "")))
    return out
